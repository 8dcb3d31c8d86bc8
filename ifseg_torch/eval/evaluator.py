"""Native-resolution mIoU evaluation.

Reference protocol (criterions/seg_criterion.py:195-217, :289-347): keep-ratio
resized image, one surrogate decoder pass, optional ResNet label propagation,
logits bilinearly upsampled to the ORIGINAL resolution, per-class confusion
areas against the original-resolution target.

As in the JAX package's ``eval/evaluator.py``, images and targets are
zero-padded into shape buckets (multiples of ``BUCKET`` pixels) and rows that
share a bucket and their ceil-16 patch extents run as ONE padded forward
whose valid region equals the unpadded math (``SegOFA.eval_forward``): the
position embeddings and the three bias systems are built once per group.  The
upsample to each row's original size uses per-row dynamic-valid
interpolation matrices, streamed in chunks of ``ROW_CHUNK`` target rows.

    evaluator = Evaluator(cfg, model)                 # on "cuda"
    logs = evaluator.eval_dataset(dataset, batch_size=8)
    miou = ...  # from the summed area_intersect / area_union of the logs

Results stay on the device until the final read-back: one synchronisation per
dataset, not per group.  The evaluator changes nothing of the model it is
given: it runs a serving copy (``serving_copy``) whose cast weights it
refreshes from that model at every ``eval_dataset``, so one evaluator built on
a trainer's model evaluates the weights as they stand.
"""

import copy
import queue
import threading
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ifseg_torch.config import Config
from ifseg_torch.data.segmentation_dataset import EvalSample, eval_mean_std
from ifseg_torch.models.encoder import compute_dtype
from ifseg_torch.models.segofa import SegOFA
from ifseg_torch.ops.histogram import confusion_areas
from ifseg_torch.ops.resize import bilinear_matrix_dyn

BUCKET = 256  # pixel granularity of shape buckets
ROW_CHUNK = 128  # original-resolution rows upsampled per step

# Peak device memory of one group, as live fp32-sized buffers: the (heads, L,
# L) bias chains are built once per group (FIXED_BIAS_BUFFERS of them; they
# set the peak of a small group), and each row adds ROW_ACT_BUFFERS buffers of
# L x D (its share of the row-chunked upsample, which sets the peak of a
# large group), L = image tokens + 64.  A group is budgeted the sum of both.
# From torch.cuda.max_memory_allocated() of groups of 4, 32 and 64 rows at the
# (512, 768) bucket, OFA-Base, 150 classes, label propagation on: 1.81 GiB at 4
# rows (15.8 bias buffers), 139.7 MiB a row between 32 and 64 (29.8 row
# buffers), rounded up (chip_smoke.py, evaluation phase; NVIDIA H100 80GB
# HBM3, 700.00 W).
FIXED_BIAS_BUFFERS = 16.0
ROW_ACT_BUFFERS = 30.0
# share of the free device memory one group may take, when no budget is given:
# a choice, not a measurement; the other half is left to the allocator's
# cached blocks and to whatever else the process holds on the card
FREE_MEMORY_SHARE = 0.5


def _bucket(n: int) -> int:
    return max(-(-n // BUCKET) * BUCKET, BUCKET)


def group_key(sample: EvalSample) -> tuple:
    """The key under which ``Evaluator.eval_dataset`` groups rows: the shape
    buckets of image and target plus the ceil-16 patch extents (the
    group-shared positions and biases; ``_pack_group`` asserts the contract)
    and the prompt length.  Under a keep-ratio resize the short edge is
    pinned, so the ceil extents cluster almost as tightly as the buckets:
    exact pixel shapes, nearly all unique, still batch."""
    (h, w), (ho, wo) = sample.patch_image.shape[:2], sample.ori_semantic_seg.shape[:2]
    return (_bucket(h), _bucket(w), _bucket(ho), _bucket(wo), -(-h // 16), -(-w // 16),
            sample.src_tokens.shape[0])


def serving_copy(model: SegOFA, device: torch.device, dtype: torch.dtype):
    """(copy, pairs): a module tree of its own for a no-gradient forward of
    ``model`` on ``device``, in eval mode, with the ``serving_linears`` in
    ``dtype`` and the stem's folded convolutions cached in ``dtype``, as
    ``cast_for_serving`` leaves a model.  Every parameter and buffer that
    already lies on ``device`` in the dtype the copy needs is shared with
    ``model``, not copied; the others get tensors of their own, and ``pairs``
    lists them as (own tensor, ``model``'s tensor) for
    ``Evaluator.refresh_weights``.  Nothing of ``model`` changes: not a
    tensor, not its training flag."""
    cast = {id(p) for m in model.serving_linears() for p in m.parameters()}
    memo, pairs = {}, []
    for t in [*model.parameters(), *model.buffers()]:
        want = dtype if id(t) in cast else t.dtype
        if t.device == device and t.dtype == want:
            memo[id(t)] = t
            continue
        own = t.detach().to(device=device, dtype=want, copy=True)
        if isinstance(t, torch.nn.Parameter):
            own = torch.nn.Parameter(own, requires_grad=False)
        memo[id(t)] = own
        pairs.append((own, t))
    for m in model.modules():  # dropout generators stay shared (unused in eval mode)
        if getattr(m, "generator", None) is not None:
            memo[id(m.generator)] = m.generator
    shadow = copy.deepcopy(model, memo).eval()
    shadow.encoder.embed_images.fold(dtype)
    return shadow, pairs


def masked_label_propagation(probs, resnet_feats, key_valid, topk: int, iters: int):
    """ResNet top-k cosine label propagation (seg_criterion.py:197-213) with
    the padded cells excluded from the similarity graph.  probs (B, L, C),
    resnet_feats (B, L, F), key_valid (L,) bool -> (B, L, C) fp32.  The
    similarity product is one plain fp32 ``matmul``."""
    f = resnet_feats.float()
    f = f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    sim = torch.matmul(f, f.transpose(1, 2))
    sim = sim.masked_fill(~key_valid[None, None, :], float("-inf"))
    topk_ind = sim.topk(topk, dim=-1).indices  # (B, L, k)
    rows = torch.arange(probs.shape[0], device=probs.device)[:, None, None]
    out = probs.float()
    for _ in range(iters):
        out = out[rows, topk_ind].mean(dim=2)  # (B, L, k, C) -> (B, L, C)
    return out


def _upsampled_areas_dyn(grid, target, valid, num_classes: int, uh, uw, chunks: int):
    """Chunked upsample of ``grid`` (B, Hp, Wp, C) by per-row matrices ``uh``
    (B, Ho, Hp) and ``uw`` (B, Wo, Wp) against ``target`` (B, Ho, Wo) under
    ``valid`` (B, Ho, Wo) bool -> ((intersect, pred, label, union) per class,
    (ce_sum, ce_count)), summed over the batch.  Rows first, from the small
    grid, so the full-width intermediate is never read twice."""
    ho = uh.shape[1]
    rows = ho // chunks
    areas = [grid.new_zeros(num_classes, dtype=torch.float32) for _ in range(4)]
    ce_sum = grid.new_zeros((), dtype=torch.float32)
    ce_cnt = grid.new_zeros((), dtype=torch.float32)
    grid = grid.float()
    for i in range(chunks):
        sl = slice(i * rows, (i + 1) * rows)
        t_ = torch.einsum("brk,bkjc->brjc", uh[:, sl], grid)
        chunk = torch.einsum("bWj,brjc->brWc", uw, t_)
        tgt, vld = target[:, sl], valid[:, sl]
        part = confusion_areas(chunk.argmax(dim=-1), tgt, num_classes, valid=vld)
        areas = [a + x for a, x in zip(areas, part)]
        lse = torch.logsumexp(chunk, dim=-1)
        zt = chunk.gather(-1, tgt.clamp(0, num_classes - 1)[..., None]).squeeze(-1)
        wv = vld.float()
        ce_sum = ce_sum + ((lse - zt) * wv).sum()
        ce_cnt = ce_cnt + wv.sum()
    return tuple(areas), (ce_sum, ce_cnt)


class Evaluator:
    """Evaluates ``model`` on its device, in eval mode, with the weights its
    forward multiplies with in the compute dtype, WITHOUT changing ``model``:
    the forward runs on ``self.model``, a serving copy (``serving_copy``)
    that shares what needs no cast or move and holds its own cast weights,
    refreshed from ``model`` at the start of every ``eval_dataset``
    (``refresh_weights``).  An evaluator built once on a trainer's model thus
    evaluates the weights as they stand, and the trainer's fp32 parameters
    stay fp32, as the JAX evaluator takes ``params`` per call.  (``SegServer``
    is the other way round: it owns its model and casts it in place.)

    ``device=None`` means ``"cuda"`` and raises when no card is present; the
    CPU is used only when the caller passes ``device="cpu"``.  ``mem_budget``
    is the device memory in bytes one group may take; by default a share of
    what is free on the card when the evaluator is built (no limit on the
    CPU)."""

    def __init__(self, cfg: Config, model: SegOFA,
                 device: Optional[Union[str, torch.device]] = None,
                 mem_budget: Optional[float] = None):
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Evaluator: no CUDA device (pass device='cpu' to run on the CPU)")
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" means the current card; its tensors say "cuda:<index>",
            # and serving_copy shares what already lies there
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = None
        self._dtype = compute_dtype(cfg.model)
        if model is not None:
            self.model, self._pairs = serving_copy(model, self.device, self._dtype)
        if mem_budget is None and self.device.type == "cuda":
            mem_budget = FREE_MEMORY_SHARE * torch.cuda.mem_get_info(self.device)[0]
        self.mem_budget = mem_budget
        mean, std = eval_mean_std(cfg.task)
        self._mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(std, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- one group

    @torch.no_grad()
    def _forward_group(self, src_tokens, image, bos, target, meta) -> Dict[str, torch.Tensor]:
        """The packed arrays of ``_pack_group`` -> summed areas and CE of the
        group's valid rows, as tensors on the device."""
        cfg, dev = self.cfg, self.device
        crit = cfg.criterion
        num_seg = cfg.model.num_seg_tokens
        img_h, img_w, ori_h, ori_w = (meta[i] for i in range(4))
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)
        row_valid = to_dev(meta[4]).bool()
        image = to_dev(image)
        if image.dtype == torch.uint8:
            # uint8 wire: normalized here, and the pad zeroed again after it
            # (a normalized zero pixel is -mean/std; the stem's masking
            # contract is a pad of exactly 0)
            hb, wb = image.shape[1:3]
            inside = (
                (torch.arange(hb, device=dev)[None, :, None] < to_dev(img_h)[:, None, None])
                & (torch.arange(wb, device=dev)[None, None, :] < to_dev(img_w)[:, None, None])
            )
            image = ((image.float() / 255.0 - self._mean) / self._std) * inside[..., None]
        target = to_dev(target).long()

        logits, enc = self.model.eval_forward(
            to_dev(src_tokens).long(), image, img_h, img_w, to_dev(bos).long(),
            crit.full_context_alignment,
        )
        gh, gw = enc["image_embed_shape"]
        hp, wp = enc["valid_hw"]
        hw = gh * gw
        b, c = logits.shape[0], logits.shape[-1]
        grid_logits = logits[:, :hw].float()

        # per-row dynamic-valid upsample of the valid (hp, wp) grid -> original
        ho, wo = target.shape[1:3]
        uh = to_dev(np.stack([bilinear_matrix_dyn(gh, ho, int(v), hp) for v in ori_h]))
        uw = to_dev(np.stack([bilinear_matrix_dyn(gw, wo, int(v), wp) for v in ori_w]))
        in_bounds = (
            (torch.arange(ho, device=dev)[None, :, None] < to_dev(ori_h)[:, None, None])
            & (torch.arange(wo, device=dev)[None, None, :] < to_dev(ori_w)[:, None, None])
        )
        # replicated padding rows carry weight 0 in every sum
        valid = in_bounds & (target != num_seg) & row_valid[:, None, None]
        chunks = ho // ROW_CHUNK

        areas, (ce_sum, ce_cnt) = _upsampled_areas_dyn(
            grid_logits.reshape(b, gh, gw, c), target, valid, num_seg, uh, uw, chunks)
        out = dict(zip(("area_intersect", "area_pred_label", "area_label", "area_union"), areas))
        if crit.resnet_iters > 0:
            probs = torch.softmax(grid_logits / crit.resnet_prob_temperature, dim=-1)
            probs = probs * enc["grid_valid"][None, :, None]
            post = masked_label_propagation(
                probs, enc["image_embed_before_proj"], enc["grid_valid"],
                crit.resnet_topk, crit.resnet_iters)
            pareas, _ = _upsampled_areas_dyn(
                post.reshape(b, gh, gw, c), target, valid, num_seg, uh, uw, chunks)
            for name, a in zip(("area_intersect", "area_pred_label", "area_label", "area_union"),
                               pareas):
                out[name + "_resnet_postprocess"] = a
        # the SUM and the COUNT, not only the ratio: group sizes differ, and a
        # reduction over groups or processes sums them (loss = Σsum / Σcnt)
        out["nll_sum"], out["nll_cnt"] = ce_sum, ce_cnt
        out["nll_loss"] = ce_sum / ce_cnt.clamp(min=1.0)
        out["loss"] = out["nll_loss"]
        return out

    # ---------------------------------------------------------- dataset loop

    def _max_group_rows(self, hb: int, wb: int) -> int:
        """Largest group the memory budget allows at this image bucket: a
        fixed cost for the once-per-group (heads, L, L) bias chains plus a
        per-row cost for the activations.  A power of two, since
        ``_pack_group`` pads a group's rows up to the next one: the padded
        group is then no larger than what was budgeted."""
        if self.mem_budget is None:
            return 1 << 30
        m = self.cfg.model
        ltok = (hb // 16) * (wb // 16) + 64  # image tokens + text headroom
        fixed = m.encoder_attention_heads * float(ltok) ** 2 * 4 * FIXED_BIAS_BUFFERS
        per_row = float(ltok) * m.encoder_embed_dim * 4 * ROW_ACT_BUFFERS
        rows = max(int((self.mem_budget - fixed) / per_row), 1)
        return 1 << (rows.bit_length() - 1)

    def _pack_group(self, samples: List[EvalSample]):
        """Host-side packing of a bucket group: zero-pad every sample into
        the bucket shape and pad the batch to the next power of two
        (replicating row 0 with row_valid = 0).  Returns (bucket key, (src,
        image, bos, target, meta)), the arrays and dtypes of the JAX package's
        ``_pack_group``."""
        n = len(samples)
        # group-shared forward: every row must have the same ceil-16 patch
        # extents (positions and biases are built once from them); a mixed
        # group would be silently wrong
        ceils = {
            (-(-s.patch_image.shape[0] // 16), -(-s.patch_image.shape[1] // 16))
            for s in samples
        }
        assert len(ceils) == 1, (
            f"eval group mixes ceil-16 patch extents {sorted(ceils)}; "
            "group rows by (ceil(h/16), ceil(w/16))"
        )
        hb = _bucket(max(s.patch_image.shape[0] for s in samples))
        wb = _bucket(max(s.patch_image.shape[1] for s in samples))
        ho = _bucket(max(s.ori_semantic_seg.shape[0] for s in samples))
        wo = _bucket(max(s.ori_semantic_seg.shape[1] for s in samples))
        b = 1 << (n - 1).bit_length()  # pad to the next power of two
        key = (hb, wb, ho, wo)

        num_seg = self.cfg.model.num_seg_tokens
        img_dtype = samples[0].patch_image.dtype
        assert all(s.patch_image.dtype == img_dtype for s in samples), (
            "mixed patch_image dtypes in one eval group"
        )
        tgt_dtype = np.uint8 if num_seg + 1 <= 256 else np.int32
        image = np.zeros((b, hb, wb, 3), img_dtype)
        target = np.full((b, ho, wo), num_seg, tgt_dtype)
        src = np.tile(samples[0].src_tokens[None].astype(np.int32), (b, 1))
        bos = np.tile(samples[0].bos_token[None].astype(np.int32), (b, 1))
        img_h, img_w, ori_h, ori_w = (np.empty((b,), np.int32) for _ in range(4))
        for i, s in enumerate(samples):
            image[i, : s.patch_image.shape[0], : s.patch_image.shape[1]] = s.patch_image
            target[i, : s.ori_semantic_seg.shape[0], : s.ori_semantic_seg.shape[1]] = (
                s.ori_semantic_seg
            )
            src[i] = s.src_tokens.astype(np.int32)
            bos[i] = s.bos_token.astype(np.int32)
            img_h[i], img_w[i] = s.patch_image.shape[:2]
            ori_h[i], ori_w[i] = s.ori_semantic_seg.shape[:2]
        for i in range(n, b):  # replicate row 0 (its areas are masked out)
            image[i] = image[0]
            img_h[i], img_w[i] = img_h[0], img_w[0]
            ori_h[i], ori_w[i] = ori_h[0], ori_w[0]
        row_valid = (np.arange(b) < n).astype(np.int32)
        meta = np.stack([img_h, img_w, ori_h, ori_w, row_valid])
        return key, (src, image, bos, target, meta)

    def _run_group(self, samples: List[EvalSample]) -> Dict[str, torch.Tensor]:
        """Run samples that share (image bucket, target bucket, ceil-16
        extents) — not necessarily exact shapes — as ONE padded forward."""
        _, args = self._pack_group(samples)
        return self._forward_group(*args)

    @torch.no_grad()
    def refresh_weights(self) -> None:
        """Take the given model's current weights into the serving copy: its
        own tensors copied (cast, moved) from the model's, the stem folded
        again."""
        if self.model is None:
            return
        for own, src in self._pairs:
            own.copy_(src)
        self.model.encoder.embed_images.fold(self._dtype)

    @staticmethod
    def _read_back(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in out.items()}

    def eval_sample(self, sample: EvalSample) -> Dict[str, np.ndarray]:
        return self._read_back(self._run_group([sample]))

    def eval_dataset(self, dataset, batch_size: int = 1, prefetch: int = 4,
                     stats_out: Optional[dict] = None) -> List[Dict[str, np.ndarray]]:
        """Evaluate every sample of ``dataset`` (``len`` and
        ``get_eval_sample(i)``): host preprocessing runs in a background
        thread while the device computes; samples whose shapes fall in the
        same bucket batch together, up to ``batch_size``; results stay on the
        device until the final read-back.  Returns one dict per executed
        group.

        ``stats_out`` receives ``group_sizes`` (rows per executed group, in
        launch order) and ``buckets`` (group key -> sample count).

        The given model's current weights are taken first
        (``refresh_weights``)."""
        self.refresh_weights()
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop = threading.Event()
        producer_error = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for i in range(len(dataset)):
                    if not put(dataset.get_eval_sample(i)):
                        return
            except Exception as e:  # a corrupt row: surface it in the consumer
                producer_error.append(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        groups: Dict[tuple, list] = {}
        group_sizes: list = []
        bucket_counts: Dict[tuple, int] = {}
        outs = []

        def run(samples):
            # memory-aware split: large buckets cap the rows below batch_size
            cap = self._max_group_rows(
                _bucket(max(s.patch_image.shape[0] for s in samples)),
                _bucket(max(s.patch_image.shape[1] for s in samples)),
            )
            for i in range(0, len(samples), cap):
                sub = samples[i: i + cap]
                group_sizes.append(len(sub))
                outs.append(self._run_group(sub))

        try:
            while True:
                sample = q.get()
                if sample is None:
                    if producer_error:
                        raise RuntimeError(
                            "eval sample preprocessing failed") from producer_error[0]
                    break
                skey = group_key(sample)
                bucket_counts[skey] = bucket_counts.get(skey, 0) + 1
                groups.setdefault(skey, []).append(sample)
                if len(groups[skey]) >= max(batch_size, 1):
                    run(groups.pop(skey))
            for rest in groups.values():
                run(rest)
        finally:
            stop.set()
            thread.join(timeout=5.0)
        if stats_out is not None:
            stats_out["group_sizes"] = group_sizes
            stats_out["buckets"] = bucket_counts
        return [self._read_back(o) for o in outs]
