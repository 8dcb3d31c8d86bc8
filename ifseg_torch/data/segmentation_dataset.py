"""The evaluation side of the segmentation dataset: TSV rows -> ragged
``EvalSample``s, and the category prompt.

A copy of the evaluation path of the JAX package's
``data/segmentation_dataset.py`` (reference data/mm_data/segmentation_dataset.py):

  - each row is a base64 image PNG, a base64 label PNG and an id; the PNGs
    are decoded by ``data/png.py`` (what PIL gives: palette files as raw
    indices, no ``.convert``); a 2-D image is replicated to three channels,
    an alpha channel dropped, and the image kept BGR through the resize
    (ref :213-218);
  - the label shift: 0 -> 255 -> -1 -> unknown = num_seg (ref :230-234);
  - the keep-ratio resize of the image into (4s, s) (ref :169-173,
    ``data/transforms.py``, equal to cv2's); the label stays at its original
    resolution;
  - one source sequence for every row: [bos, prompt, class names...,
    unknown, eos] (ref :272-281).

The training side (augmentations, artificial grids, ``SegBatch``) comes with
the training pipeline.  ``EvalSample`` and ``eval_mean_std`` are what the
evaluator reads.
"""

import base64
from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np

from ifseg_torch.data.png import decode_png
from ifseg_torch.data.transforms import KeepRatioResize

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
    """Evaluation rows of a TSV ``dataset`` (``data/file_dataset.py``)."""

    def __init__(self, split: str, dataset, bpe, dictionary, cfg):
        if split == "train":
            raise NotImplementedError(
                "the training pipeline (augmentations, artificial grids, SegBatch) comes "
                "with cli/train (ROADMAP.md A.5); this dataset serves evaluation rows")
        self.split = split
        self.dataset = dataset
        self.bpe = bpe
        self.dict = dictionary
        self.cfg = cfg
        s = cfg.patch_image_size
        self.num_seg = cfg.num_seg_tokens
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

    def __len__(self):
        return len(self.dataset)

    def _decode_row(self, index: int):
        image_b64, seg_b64, uniq_id = self.dataset[index]
        image_arr = decode_png(base64.urlsafe_b64decode(image_b64))
        if image_arr.ndim < 3:
            image_arr = np.repeat(image_arr[:, :, None], 3, axis=2)
        elif image_arr.shape[2] == 4:
            image_arr = image_arr[:, :, :3]
        image_arr = image_arr[:, :, ::-1].copy()  # to BGR (ref :218)
        seg = decode_png(base64.urlsafe_b64decode(seg_b64))
        # label shift (ref :230-234)
        seg = seg.astype(np.int32)
        seg[seg == 0] = 255
        seg = seg - 1
        seg[seg == 254] = self.num_seg
        return image_arr, seg, uniq_id

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
