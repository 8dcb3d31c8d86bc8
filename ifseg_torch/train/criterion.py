"""The IFSeg criterion (mirrors criterions/seg_criterion.py as the JAX
package's ``train/criterion.py`` computes it).

  - ``upsampled_ce``: logits grid (trailing eos slot dropped) bilinearly
    upsampled 32x32 -> HxW with the exact torch ``align_corners=False``
    interpolation matrices, in chunks of output rows so the (B, H, W, C)
    tensor never exists: each chunk is recomputed in the backward
    (``torch.utils.checkpoint``), which keeps the memory at one chunk.
    Chunks are emitted in bf16 from bf16 operands with fp32 accumulation, and
    the CE reduces them in fp32.
  - ``compute_imfree_loss``: mean CE over the non-unknown cells of the
    upsampled artificial-grid logits against the nearest-upsampled category
    grid.  Targets are raw class ids in [0, num_seg]; num_seg = unknown.
  - ``compute_monitor_outputs``: display loss plus full-resolution and
    low-resolution confusion areas of the real-image logits.
  - label smoothing matches ``F.cross_entropy(label_smoothing=eps)`` in
    closed form: (1-eps) * nll + eps * (lse - mean_c z).
  - ``init_seg_embeddings``: seg_embed_tokens <- per-class mean of the
    category-word token embeddings, applied once before step 0.
"""

from typing import Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ifseg_torch.models.encoder import class_mean_embeddings
from ifseg_torch.ops.histogram import confusion_areas
from ifseg_torch.ops.resize import bilinear_tensor


class LossOut(NamedTuple):
    loss_sum: torch.Tensor  # scalar fp32
    count: torch.Tensor  # scalar fp32 (valid cells)


def _ce_from_logits(logits, target, valid, label_smoothing: float) -> LossOut:
    """Summed CE over valid cells.  logits (..., C), target int, valid bool.
    nll = logsumexp(z) - z[t]; label smoothing uses the closed form
    mean_c(-log p_c) = lse - mean_c(z), so the log-probabilities are never
    materialised."""
    logits = logits.float()
    c = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    zt = logits.gather(-1, target.clamp(0, c - 1)[..., None]).squeeze(-1)
    nll = lse - zt
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    w = valid.float()
    return LossOut((nll * w).sum(), w.sum())


def _grid_from_logits(logits, hw: Tuple[int, int]):
    """(B, 1+hw, C) decoder output -> (B, h, w, C) grid, eos slot dropped."""
    h, w = hw
    grid = logits[:, : h * w, :]
    return grid.reshape(grid.shape[0], h, w, grid.shape[-1])


def _upsample_rows(grid, ah_c, aw, chunk_dtype):
    """Output rows ``ah_c`` (rows, h) of the bilinear upsample of ``grid``
    (B, h, w, C) -> (B, rows, W, C): rows first, then the full width.  The
    operands may be bf16; both products accumulate, and the first one stays,
    in fp32.  As in the JAX package, the gradient that flows back to a bf16
    ``grid`` is rounded to bf16 per chunk."""
    t = torch.einsum("rk,bkjc->brjc", ah_c.float(), grid.float())
    chunk = torch.einsum("Wj,brjc->brWc", aw.float(), t)
    return chunk if chunk_dtype is None else chunk.to(chunk_dtype)


def _row_chunks(grid, out_hw, row_chunks: int, chunk_dtype=None):
    """(grid, [(ah_chunk, row_slice), ...], aw) for a row-chunked upsample.
    With ``chunk_dtype`` the grid and the matrices are cast to it (bf16
    operands; ``_upsample_rows`` accumulates in fp32)."""
    _, h, w, _ = grid.shape
    H, W = out_hw
    if H % row_chunks:
        raise ValueError(f"{H} output rows do not split into {row_chunks} chunks")
    rows = H // row_chunks
    ah = bilinear_tensor(h, H, grid.device)
    aw = bilinear_tensor(w, W, grid.device)
    grid = grid.float()
    if chunk_dtype is not None:
        grid, ah, aw = (x.to(chunk_dtype) for x in (grid, ah, aw))
    chunks = [(ah[i * rows:(i + 1) * rows], slice(i * rows, (i + 1) * rows))
              for i in range(row_chunks)]
    return grid, chunks, aw


def upsampled_ce(grid_logits, target, valid, label_smoothing: float = 0.0,
                 row_chunks: int = 8) -> LossOut:
    """CE against the bilinear upsample of ``grid_logits`` (B, h, w, C),
    streamed by rows.  target (B, H, W) int class ids; valid (B, H, W) bool."""

    def chunk_ce(grid, ah_c, aw, tgt, vld):
        chunk = _upsample_rows(grid, ah_c, aw, torch.bfloat16)
        return tuple(_ce_from_logits(chunk, tgt, vld, label_smoothing))

    grid, chunks, aw = _row_chunks(grid_logits, target.shape[1:3], row_chunks, torch.bfloat16)
    loss_sum = grid.new_zeros((), dtype=torch.float32)
    count = grid.new_zeros((), dtype=torch.float32)
    for ah_c, rows in chunks:
        ls, n = checkpoint(chunk_ce, grid, ah_c, aw, target[:, rows], valid[:, rows],
                           use_reentrant=False)
        loss_sum, count = loss_sum + ls, count + n
    return LossOut(loss_sum, count)


def upsampled_areas(grid_logits, target, valid, num_classes: int, row_chunks: int = 8):
    """Per-class confusion areas of argmax(upsampled logits) vs target."""
    grid, chunks, aw = _row_chunks(grid_logits, target.shape[1:3], row_chunks)
    areas = [grid.new_zeros(num_classes, dtype=torch.float32) for _ in range(4)]
    for ah_c, rows in chunks:
        pred = _upsample_rows(grid, ah_c, aw, None).argmax(dim=-1)
        part = confusion_areas(pred, target[:, rows], num_classes, valid=valid[:, rows])
        areas = [a + x for a, x in zip(areas, part)]
    return tuple(areas)


def compute_imfree_loss(aux_logits, aux_target, num_seg: int, patch_hw: Tuple[int, int],
                        label_smoothing: float = 0.0, row_chunks: int = 8, count=None):
    """Image-free training loss: mean CE over non-unknown cells.  aux_logits
    (B, 1+hw, C) decoder output on the artificial image; aux_target (B, S, S)
    int class ids.  ``count``: the cells the mean is over, where they are
    more than these rows' (a batch split across processes: each process's
    share of the global mean)."""
    grid = _grid_from_logits(aux_logits, patch_hw)
    valid = aux_target != num_seg
    out = upsampled_ce(grid, aux_target, valid, label_smoothing, row_chunks)
    return out.loss_sum / (out.count if count is None else count).clamp(min=1.0)


def compute_monitor_outputs(logits, target, downsampled_target, num_seg: int,
                            patch_hw: Tuple[int, int], label_smoothing: float = 0.0,
                            row_chunks: int = 8, count=None) -> Dict[str, torch.Tensor]:
    """Monitoring pass on the real image: display loss + full-resolution and
    low-resolution confusion areas.  logits (B, 1+hw, C); target (B, S, S);
    downsampled_target (B, hw).  The caller runs it without gradients.
    ``count`` as ``compute_imfree_loss`` takes it."""
    grid = _grid_from_logits(logits, patch_hw)
    valid = target != num_seg
    out = upsampled_ce(grid, target, valid, label_smoothing, row_chunks)
    nll = out.loss_sum / (out.count if count is None else count).clamp(min=1.0)
    ai, ap, al, au = upsampled_areas(grid, target, valid, num_seg, row_chunks)

    h, w = patch_hw
    low_pred = grid.reshape(grid.shape[0], h * w, num_seg).argmax(dim=-1)
    low_valid = downsampled_target != num_seg
    lai, lap, lal, lau = confusion_areas(low_pred, downsampled_target, num_seg, valid=low_valid)
    return {
        "nll_loss": nll,
        "area_intersect": ai, "area_pred_label": ap, "area_label": al, "area_union": au,
        "area_intersect_lowres": lai, "area_pred_label_lowres": lap,
        "area_label_lowres": lal, "area_union_lowres": lau,
    }


@torch.no_grad()
def init_seg_embeddings(model, class_tokens, class_lengths, num_seg: int):
    """Lazy seg-embedding initialisation: seg_embed_tokens (and an untied
    seg_projection) <- per-class mean of the category-word token embeddings
    of the first ``num_seg`` classes (no 'unknown' row).  In place; apply once
    after the weights are loaded, before step 0."""
    table = model.encoder.embed_tokens.weight
    avg = class_mean_embeddings(
        table,
        torch.as_tensor(class_tokens, device=table.device)[:num_seg].long(),
        torch.as_tensor(class_lengths, device=table.device)[:num_seg],
    ).to(table.dtype)
    model.decoder.seg_embed_tokens.weight.copy_(avg)
    if model.decoder.seg_projection is not None:
        model.decoder.seg_projection.weight.copy_(avg)
    return model
