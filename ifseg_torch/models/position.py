"""OFA positional machinery: bucket tables and bias assembly.

Three bias systems feed every attention site:
  1. absolute position bias: LN(pos_embed) -> pos_q/pos_k linear -> q·kᵀ per
     head (built by the encoder and decoder modules);
  2. token relative bias: log-bucketed relative positions;
  3. 2-D image/seg relative bias over grid pairs with special CLS/BOS
     buckets, bilinearly interpolated on each grid pair when the runtime grid
     differs from the bucket grid.

The bucket tables are static numpy, cached per shape; the lookups and the
interpolation products run on tensors.  The all-layer lookup is a plain
gather; in training its backward is autograd's ``index_add_`` into the
stacked tables, accumulated in fp32.
"""

from functools import lru_cache

import numpy as np
import torch

from ifseg_torch.ops.resize import bilinear_tensor


@lru_cache(maxsize=None)
def make_token_bucket_position(bucket_size: int, max_position: int = 1024) -> np.ndarray:
    """Log-bucketed relative positions (encoder_module.py:71-84): |rel| <= mid
    keeps the signed offset; larger offsets are log-spaced into mid-1 buckets."""
    context = np.arange(max_position, dtype=np.int64)[:, None]
    memory = np.arange(max_position, dtype=np.int64)[None, :]
    rel = context - memory
    sign = np.sign(rel)
    mid = bucket_size // 2
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    with np.errstate(divide="ignore"):
        log_pos = (
            np.ceil(
                np.log(abs_pos / mid) / np.log((max_position - 1) / mid) * (mid - 1)
            )
            + mid
        )
    log_pos = log_pos.astype(np.int32)
    bucket = np.where(abs_pos <= mid, rel, (log_pos * sign).astype(np.int64))
    return (bucket + bucket_size - 1).astype(np.int32)


@lru_cache(maxsize=None)
def make_image_bucket_position(bucket_size: int, num_relative_distance: int) -> np.ndarray:
    """2-D relative-position index over a (bucket_size² + 1) token grid with a
    leading CLS slot (encoder_module.py:87-104)."""
    coords = np.stack(
        np.meshgrid(np.arange(bucket_size), np.arange(bucket_size), indexing="ij")
    )  # (2, H, W)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, HW, HW)
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += bucket_size - 1
    rel[:, :, 1] += bucket_size - 1
    rel[:, :, 0] *= 2 * bucket_size - 1
    index = np.zeros((bucket_size**2 + 1,) * 2, dtype=np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_relative_distance - 3
    index[0:, 0] = num_relative_distance - 2
    index[0, 0] = num_relative_distance - 1
    return index.astype(np.int32)


def image_num_rel_dis(image_bucket_size: int) -> int:
    return (2 * image_bucket_size - 1) * (2 * image_bucket_size - 1) + 3


@lru_cache(maxsize=None)
def image_grid_position_ids(h: int, w: int, image_bucket_size: int) -> np.ndarray:
    """Flattened grid position ids: row*bucket + col + 1 (encoder_module.py:339-341)."""
    ids = (
        np.arange(w, dtype=np.int64)[None, :]
        + np.arange(h, dtype=np.int64)[:, None] * image_bucket_size
        + 1
    )
    return ids.reshape(-1).astype(np.int32)


@lru_cache(maxsize=None)
def image_rp_bucket_for_grid(h: int, w: int, image_bucket_size: int) -> np.ndarray:
    """(h*w, h*w) bucket indices for a grid, via pairwise gather of the full
    bucket table (encoder_module.py:321-331)."""
    table = make_image_bucket_position(
        image_bucket_size, image_num_rel_dis(image_bucket_size)
    )
    pos = image_grid_position_ids(h, w, image_bucket_size)
    return table[np.ix_(pos, pos)].astype(np.int32)


def gather_rel_bias_all_layers(table: torch.Tensor, rp_bucket: np.ndarray) -> torch.Tensor:
    """All-layer bias lookup in one gather: (layers, num_rel, H) table x
    (L1, L2) int buckets -> (layers, H, L1, L2) fp32.

    Differentiable in ``table`` by plain indexing: the backward is one
    ``index_add_`` of the fp32 cotangent."""
    layers, num_rel, h = table.shape
    cat = table.permute(1, 0, 2).reshape(num_rel, layers * h)
    idx = torch.from_numpy(np.ascontiguousarray(rp_bucket, dtype=np.int64)).to(table.device)
    v = cat.index_select(0, idx.reshape(-1)).reshape(*rp_bucket.shape, layers, h)
    return v.permute(2, 3, 0, 1).float()


def gather_grid_bias_all_layers(table: torch.Tensor, rp_bucket: np.ndarray, grid_hw,
                                bos: bool = False, dtype=torch.float32) -> torch.Tensor:
    """``gather_rel_bias_all_layers`` for 2-D grid buckets (with a leading
    BOS/CLS slot when ``bos``), emitted in ``dtype``: (layers, H, L, L) with
    L = h*w (+1).  The gather runs in fp32 and is cast after, so the table
    gradient accumulates in fp32 whatever ``dtype`` is.  The JAX package
    computes the same values by delta expansion with a hand-written
    backward; here both directions are plain indexing."""
    h, w = grid_hw
    l = h * w + (1 if bos else 0)
    if tuple(rp_bucket.shape) != (l, l):
        raise ValueError(f"bucket matrix {rp_bucket.shape} does not fit grid {grid_hw}, bos={bos}")
    return gather_rel_bias_all_layers(table, rp_bucket).to(dtype)


def interp_grid_bias(bias: torch.Tensor, src_hw, dst_hw) -> torch.Tensor:
    """Double-bilinear interpolation of a grid-pair bias: (heads, sh*sw,
    sh*sw) -> (heads, dh*dw, dh*dw), over the query-grid axes, then the
    key-grid axes (encoder_module.py:799-808)."""
    sh, sw = src_hw
    dh, dw = dst_hw
    if (sh, sw) == (dh, dw):
        return bias
    ah = bilinear_tensor(sh, dh, bias.device)
    aw = bilinear_tensor(sw, dw, bias.device)
    heads = bias.shape[0]
    b = bias.reshape(heads, sh, sw, sh, sw).float()
    b = torch.einsum("Hi,hiwjv->hHwjv", ah, b)
    b = torch.einsum("Wi,hHijv->hHWjv", aw, b)
    b = torch.einsum("Ji,hHWiv->hHWJv", ah, b)
    b = torch.einsum("Vi,hHWJi->hHWJV", aw, b)
    return b.reshape(heads, dh * dw, dh * dw)


def interp_seg_bias_with_bos(bias: torch.Tensor, src_hw, dst_hw) -> torch.Tensor:
    """Seg-grid bias interpolation with the BOS slot (decoder_module.py:
    601-627): the leading row and column pass through unresized along their
    own axis while the grid block is interpolated on both grid pairs.

    ``bias``: (heads, 1 + sh*sw, 1 + sh*sw) -> (heads, 1 + dh*dw, 1 + dh*dw).
    """
    sh, sw = src_hw
    dh, dw = dst_hw
    if (sh, sw) == (dh, dw):
        return bias
    ah = bilinear_tensor(sh, dh, bias.device)
    aw = bilinear_tensor(sw, dw, bias.device)
    heads = bias.shape[0]

    def interp_flat(x):  # (heads, N, sh*sw) -> (heads, N, dh*dw)
        n = x.shape[1]
        x = x.reshape(heads, n, sh, sw)
        x = torch.einsum("Hi,bniw->bnHw", ah, x)
        x = torch.einsum("Wi,bnhi->bnhW", aw, x)
        return x.reshape(heads, n, dh * dw)

    bias = bias.float()
    bos_row = bias[:, :1, :]
    grid_rows = interp_flat(bias[:, 1:, :].transpose(1, 2)).transpose(1, 2)
    bias = torch.cat([bos_row, grid_rows], dim=1)  # (H, 1+dh*dw, 1+sh*sw)
    bos_col = bias[:, :, :1]
    grid_cols = interp_flat(bias[:, :, 1:])
    return torch.cat([bos_col, grid_cols], dim=2)
