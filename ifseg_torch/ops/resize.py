"""Bilinear resize with PyTorch ``F.interpolate(align_corners=False)``
semantics, as a fixed (out, in) matrix per axis.

The matrix form lets one resize act on any pair of axes (grid-pair biases
are resized on four axes) and keeps the arithmetic identical to the JAX
package's ``ops/resize.py``.
"""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fp32 interpolation matrix matching torch bilinear
    (half-pixel centres, negative source coordinates clamped to 0)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    out = np.arange(out_size, dtype=np.float64)
    src = np.clip((out + 0.5) * (in_size / out_size) - 0.5, 0.0, None)
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    w_hi = np.clip(src - lo, 0.0, 1.0)
    w_lo = 1.0 - w_hi
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), lo] += w_lo
    mat[np.arange(out_size), hi] += w_hi
    return mat.astype(np.float32)


def bilinear_tensor(in_size: int, out_size: int, device) -> torch.Tensor:
    return torch.from_numpy(bilinear_matrix(in_size, out_size)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw, h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """Bilinear-resize two axes of ``x`` (default layout ``(..., H, W, C)``),
    in fp32, returning ``x``'s dtype."""
    h_axis %= x.dim()
    w_axis %= x.dim()
    out_h, out_w = out_hw
    xf = x.float()
    for axis, out_size in ((h_axis, out_h), (w_axis, out_w)):
        in_size = xf.shape[axis]
        if in_size != out_size:
            a = bilinear_tensor(in_size, out_size, x.device)
            xf = torch.movedim(torch.tensordot(a, xf, dims=([1], [axis])), 0, axis)
    return xf.to(x.dtype)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output position, ``F.interpolate(mode="nearest")``
    semantics: floor(i * in / out)."""
    idx = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def resize_nearest_np(x: np.ndarray, out_hw, h_axis: int = -2, w_axis: int = -1) -> np.ndarray:
    """Numpy nearest-resize of two axes (host-side data pipeline)."""
    h_axis %= x.ndim
    w_axis %= x.ndim
    x = np.take(x, nearest_indices(x.shape[h_axis], out_hw[0]), axis=h_axis)
    return np.take(x, nearest_indices(x.shape[w_axis], out_hw[1]), axis=w_axis)
