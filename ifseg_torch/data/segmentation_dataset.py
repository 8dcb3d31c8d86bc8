"""Segmentation dataset: TSV rows -> training batches and evaluation rows.

A copy of the JAX package's ``data/segmentation_dataset.py`` (reference
data/mm_data/segmentation_dataset.py):

  - each row is a base64 image, a base64 label image and an id; both are
    decoded by ``data/image.py``, PNG, JPEG, GIF, BMP, TIFF, WebP, JPEG 2000,
    ICO, CUR, Netpbm or PSD by their signature (what PIL gives: palette files
    as raw indices, a 16-bit PGM's "I" as int32, which the resize then
    refuses as cv2 refuses it, no
    ``.convert``, a cut file as PIL reads it under the JAX package's
    ``LOAD_TRUNCATED_IMAGES``); a 2-D image is replicated to three
    channels, a fourth channel (alpha, or a CMYK file's K) dropped, and the
    image kept BGR through the transforms (ref :213-218);
  - the label shift: 0 -> 255 -> -1 -> unknown = num_seg (ref :230-234);
  - training rows: ResizeRatioRange(0.5, 2.0, min_size=s) + RandomCrop(s,
    0.75) + RandomFlip(0.5) + PhotoMetricDistortion (ref :157-163), each
    drawing from the row's generator (``data/transforms.py``, equal to the
    JAX package's cv2 transforms); min_size makes every crop exactly (s, s);
    then an artificial grid (``data/artificial.py``) from the same
    generator.  On the image-free fast path (``decode_real_images`` False
    with a ``rand_k`` grid) the row is read and never decoded;
  - ``collate_train`` stacks training rows into a ``SegBatch`` whose targets
    ride uint8 where the class ids fit;
  - evaluation rows: the keep-ratio resize of the image into (4s, s) (ref
    :169-173); the label stays at its original resolution;
  - one source sequence for every row: [bos, prompt, class names...,
    unknown, eos] (ref :272-281).

``EvalSample`` and ``eval_mean_std`` are what the evaluator reads.
"""

import base64
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ifseg_torch.data.artificial import artificial_grid
from ifseg_torch.data.image import decode_image
from ifseg_torch.data.transforms import (
    KeepRatioResize,
    PhotoMetricDistortion,
    RandomCrop,
    RandomFlip,
    ResizeRatioRange,
)
from ifseg_torch.ops.resize import resize_nearest_np
from ifseg_torch.tokenization.dictionary import build_seg_dictionary
from ifseg_torch.tokenization.gpt2_bpe import GPT2BPE

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def eval_mean_std(cfg) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Normalization constants of the task config ``cfg``, shared by the
    trainer's and the evaluator's on-device normalize (images ship as uint8:
    a quarter of the bytes of normalized fp32)."""
    if cfg.imagenet_default_mean_and_std:
        return IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    return (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)


def encode_text(bpe, dictionary, text: str) -> np.ndarray:
    """BPE-encode per word with a leading space, then map to dict ids
    (ref segmentation_dataset.py:193-208, no bos/eos)."""
    line = " ".join(
        bpe.encode(" {}".format(word.strip())) for word in text.strip().split()
    )
    return dictionary.encode_line(line, append_eos=False)


def build_class_token_table(bpe, dictionary, categories: List[str]):
    """Padded (C, Tmax) token-id matrix + (C,) lengths for the category names
    (+ trailing 'unknown'), the EmbeddingBag inputs (ref :183-187)."""
    toks = [encode_text(bpe, dictionary, f" {c}") for c in categories]
    tmax = max(len(t) for t in toks)
    table = np.zeros((len(toks), tmax), np.int32)
    lengths = np.zeros((len(toks),), np.int32)
    for i, t in enumerate(toks):
        table[i, : len(t)] = t
        lengths[i] = len(t)
    return table, lengths


def prompt_tokens(bpe_dir: str, categories: List[str], prompt_prefix: str) -> np.ndarray:
    """(1, L) int64 source: [bos, the prompt, each class name, 'unknown', eos]."""
    dictionary = build_seg_dictionary(bpe_dir, num_seg_tokens=len(categories))
    bpe = GPT2BPE.from_dir(bpe_dir)
    parts = [np.asarray([dictionary.bos()], np.int64),
             encode_text(bpe, dictionary, f" {prompt_prefix.lstrip()}")]
    tokens_tbl, lengths_tbl = build_class_token_table(bpe, dictionary, categories + ["unknown"])
    for i in range(len(categories) + 1):
        parts.append(tokens_tbl[i, : lengths_tbl[i]].astype(np.int64))
    parts.append(np.asarray([dictionary.eos()], np.int64))
    return np.concatenate(parts)[None]


@dataclass
class SegBatch:
    """Fixed-shape training batch (numpy, NHWC)."""

    # patch_images/target/downsampled_target are None on the image-free fast
    # path (decode_real_images=False): the step never reads them
    patch_images: Optional[np.ndarray]  # (B, s, s, 3) uint8 RGB, normalized on the device
    src_tokens: np.ndarray  # (B, L) int32
    bos_tokens: np.ndarray  # (B, 1) int32
    target: Optional[np.ndarray]  # (B, s, s) uint8 class ids (int32 when num_seg+1 > 256)
    downsampled_target: Optional[np.ndarray]  # (B, (s/16)^2) int32
    aux_grid_ids: Optional[np.ndarray]  # (B, (s/16)^2) int32
    aux_target: Optional[np.ndarray]  # (B, s, s) uint8 (int32 when num_seg+1 > 256)
    ids: np.ndarray  # (B,)
    nsentences: int = 0
    ntokens: int = 0


@dataclass
class EvalSample:
    """One ragged evaluation row (the evaluator does the bucketing).

    ``patch_image`` is raw uint8 RGB, keep-ratio resized; it is normalized on
    the device.  An fp32 array is taken as already normalized and passes
    through."""

    patch_image: np.ndarray  # (h, w, 3) uint8 RGB, or fp32 normalized
    src_tokens: np.ndarray  # (L,)
    bos_token: np.ndarray  # (1,)
    ori_semantic_seg: np.ndarray  # (H, W) int class ids, original resolution
    ori_shape: Any
    id: Any = None


class SegmentationDataset:
    """Training or evaluation rows (``split``) of a TSV ``dataset``
    (``data/file_dataset.py``)."""

    def __init__(self, split: str, dataset, bpe, dictionary, cfg):
        self.split = split
        self.dataset = dataset
        self.bpe = bpe
        self.dict = dictionary
        self.cfg = cfg
        s = cfg.patch_image_size
        self.patch_image_size = s
        self.num_seg = cfg.num_seg_tokens
        if split == "train":
            self.resize = ResizeRatioRange((s * 4, s), (0.5, 2.0), min_size=s)
            self.crop = RandomCrop((s, s), cat_max_ratio=0.75)
            self.flip = RandomFlip(0.5)
            self.distort = PhotoMetricDistortion()
        else:
            self.eval_resize = KeepRatioResize((s * 4, s))

        categories = cfg.categories + ["unknown"]
        if len(categories) != self.num_seg + 1:
            raise ValueError(
                f"category_list has {len(categories) - 1} entries; expected {self.num_seg}")
        self.class_tokens, self.class_lengths = build_class_token_table(
            bpe, dictionary, categories
        )

        # constant source sequence: [bos, prompt, class names..., eos]
        # (ref :272-281); identical for every sample
        parts = [np.asarray([dictionary.bos()], np.int64)]
        if cfg.prompt_prefix:
            parts.append(encode_text(bpe, dictionary, f" {cfg.prompt_prefix.lstrip()}"))
        for i in range(len(categories)):
            parts.append(self.class_tokens[i, : self.class_lengths[i]].astype(np.int64))
        parts.append(np.asarray([dictionary.eos()], np.int64))
        self.src_item = np.concatenate(parts).astype(np.int32)

        self.artificial_image_type = cfg.artificial_image_type
        # the image-free fast path: only for rand_k grids (they carry their
        # own pixel target); norand_k takes its target from the real labels
        self.skip_real_images = (
            split == "train"
            and not cfg.decode_real_images
            and self.artificial_image_type.startswith("rand_k")
        )

    def __len__(self):
        return len(self.dataset)

    def _decode_row(self, index: int):
        image_b64, seg_b64, uniq_id = self.dataset[index]
        # by signature, the pixels PIL's np.asarray gives (no convert); a 4-channel
        # row (RGBA, CMYK) keeps its first three channels, as the JAX row does
        image_arr = decode_image(base64.urlsafe_b64decode(image_b64))[0]
        if image_arr.ndim < 3:
            image_arr = np.repeat(image_arr[:, :, None], 3, axis=2)
        elif image_arr.shape[2] == 4:
            image_arr = image_arr[:, :, :3]
        image_arr = image_arr[:, :, ::-1].copy()  # to BGR (ref :218)
        seg = decode_image(base64.urlsafe_b64decode(seg_b64))[0]
        # label shift (ref :230-234)
        seg = seg.astype(np.int32)
        seg[seg == 0] = 255
        seg = seg - 1
        seg[seg == 254] = self.num_seg
        return image_arr, seg, uniq_id

    def _artificial_grid(self, rng: np.random.Generator):
        """Random category grid -> (token-grid ids, pixel target) (ref :303-321)."""
        return artificial_grid(rng, self.patch_image_size, self.num_seg,
                               self.artificial_image_type)

    def get_train_example(self, index: int, rng: np.random.Generator) -> Dict[str, Any]:
        """Training row ``index`` with every random draw from ``rng``: the
        augmented image (uint8 RGB, normalized on the device) and labels, and
        the artificial grid; on the fast path the grid alone."""
        if self.skip_real_images:
            # the TSV row is read (so iterator positions and resumes do not
            # change) but its base64 payloads are never decoded
            uniq_id = self.dataset[index][2]
            grid_ids, aux_target = self._artificial_grid(rng)
            return {"id": uniq_id, "aux_grid_ids": grid_ids, "aux_target": aux_target}
        img_bgr, seg, uniq_id = self._decode_row(index)
        img_bgr, seg = self.resize(img_bgr, seg, rng)
        img_bgr, seg = self.crop(img_bgr, seg, rng)
        img_bgr, seg = self.flip(img_bgr, seg, rng)
        img_bgr = self.distort(img_bgr, rng)
        img = np.ascontiguousarray(img_bgr[:, :, ::-1])

        hw16 = self.patch_image_size // 16
        down = resize_nearest_np(seg, (hw16, hw16)).reshape(-1)
        ex = {
            "id": uniq_id,
            "patch_image": img,
            "target": seg.astype(np.int32),
            "downsampled_target": down.astype(np.int32),
        }
        if self.artificial_image_type != "none":
            ex["aux_grid_ids"], ex["aux_target"] = self._artificial_grid(rng)
        return ex

    def collate_train(self, examples: List[Dict[str, Any]]) -> SegBatch:
        b = len(examples)
        stack = lambda k: np.stack([e[k] for e in examples])
        has_aux = "aux_grid_ids" in examples[0]
        has_real = "patch_image" in examples[0]  # False on the fast path
        # the wire: targets ride uint8 where the class ids fit
        tgt = np.uint8 if self.num_seg + 1 <= 256 else np.int32
        return SegBatch(
            patch_images=stack("patch_image") if has_real else None,
            src_tokens=np.tile(self.src_item[None], (b, 1)),
            bos_tokens=np.full((b, 1), self.dict.bos(), np.int32),
            target=stack("target").astype(tgt) if has_real else None,
            downsampled_target=stack("downsampled_target") if has_real else None,
            aux_grid_ids=stack("aux_grid_ids") if has_aux else None,
            aux_target=(
                stack("aux_target").astype(tgt)
                if has_aux and examples[0].get("aux_target") is not None
                else None
            ),
            ids=np.asarray([e["id"] for e in examples]),
            nsentences=b,
            ntokens=int(sum((e["target"] if has_real else e["aux_target"]).size + 1
                            for e in examples)),
        )

    def get_eval_sample(self, index: int) -> EvalSample:
        img_bgr, seg, uniq_id = self._decode_row(index)
        ori_shape = img_bgr.shape
        img_resized = self.eval_resize(img_bgr)
        # raw uint8 RGB: normalization runs on the device (eval/evaluator.py)
        return EvalSample(
            patch_image=np.ascontiguousarray(img_resized[:, :, ::-1]),
            src_tokens=self.src_item,
            bos_token=np.asarray([self.dict.bos()], np.int32),
            ori_semantic_seg=seg,
            ori_shape=ori_shape,
            id=uniq_id,
        )
