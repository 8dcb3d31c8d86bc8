"""Dense CRF post-processing on the host: the C++ mean field over ctypes.

The counterpart of the JAX package's ``ops/crf.py`` (reference crf.py:11-37,
which calls the external pydensecrf package): mean-field inference with a
Gaussian and a bilateral pairwise potential on permutohedral lattices,
symmetric normalisation and Potts compatibility, in
``csrc/{permutohedral.h,densecrf.cpp}``.  The library is built with the host
C++ compiler by ``ops/build.py`` at the first call, never when this module is
imported; a failed build raises.

It is built with the package's ``HOST_FLAGS``, without ``-march=native``,
where the JAX package builds the same source with it (which lets the compiler
fuse multiply-adds): the two libraries differ by about 4.5e-7 in probability
after one iteration and 2.5e-5 after ten, and pick the same labels.

``rgb_dense_crf(image_bgr, probs, max_iter)`` keeps the reference signature:
unary from the softmax, PairwiseGaussian(sxy=1, compat=3),
PairwiseBilateral(sxy=67, srgb=3, compat=4).
"""

import ctypes
from functools import lru_cache

import numpy as np

from ifseg_torch.ops import build

SOURCE = "densecrf"


@lru_cache(maxsize=None)
def _inference():
    fn = build.load(SOURCE).dense_crf_inference
    fn.argtypes = [
        ctypes.c_void_p,  # image_bgr (H, W, 3) uint8
        ctypes.c_void_p,  # probs (H, W, C) float32
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H W C
        ctypes.c_int,  # n_iter
        ctypes.c_float, ctypes.c_float,  # gaussian sxy, compat
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # bilateral sxy, srgb, compat
        ctypes.c_void_p,  # out (H, W, C) float32
    ]
    fn.restype = None
    return fn


def dense_crf(
    image_bgr: np.ndarray,
    probs: np.ndarray,
    n_iter: int = 10,
    sxy_gauss: float = 1.0,
    compat_gauss: float = 3.0,
    sxy_bilateral: float = 67.0,
    srgb_bilateral: float = 3.0,
    compat_bilateral: float = 4.0,
) -> np.ndarray:
    """probs (H, W, C) softmax, image_bgr (H, W, 3) uint8 -> refined (H, W, C)
    float32 probabilities."""
    if probs.ndim != 3:
        raise ValueError(f"probs must be (H, W, C), not {probs.shape}")
    h, w, c = probs.shape
    if image_bgr.shape != (h, w, 3):
        raise ValueError(f"image {image_bgr.shape} does not match probs {probs.shape}")
    img = np.ascontiguousarray(image_bgr, np.uint8)
    p = np.ascontiguousarray(probs, np.float32)
    out = np.empty((h, w, c), np.float32)
    _inference()(img.ctypes.data, p.ctypes.data, h, w, c, n_iter, sxy_gauss, compat_gauss,
                 sxy_bilateral, srgb_bilateral, compat_bilateral, out.ctypes.data)
    return out


def rgb_dense_crf(image_bgr: np.ndarray, probs: np.ndarray, max_iter: int = 10) -> np.ndarray:
    """The reference signature (crf.py:19-37).  ``probs`` may be (C, H, W),
    channel first as in the reference, or (H, W, C); the result has the same
    layout."""
    channel_first = probs.ndim == 3 and probs.shape[0] < probs.shape[2]
    p = probs.transpose(1, 2, 0) if channel_first else probs
    out = dense_crf(image_bgr, p, n_iter=max_iter)
    return out.transpose(2, 0, 1) if channel_first else out
