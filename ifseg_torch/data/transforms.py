"""The evaluation resize of the data pipeline, in numpy, equal to cv2's.

The JAX package's ``data/transforms.py`` resizes with
``cv2.resize(..., INTER_LINEAR)`` (mmcv's image ops are cv2-backed).  The
port depends on no image library, so ``resize_image`` reproduces what cv2
computes for uint8 images, bit for bit:

  - an output of the input's size is a copy;
  - an exact 2x down-scale on both sides is cv2's area average:
    (a + b + c + d + 2) >> 2 over each 2 x 2 block;
  - otherwise cv2's fixed-point bilinear: source coordinates
    ``float32((x + 0.5) * scale - 0.5)`` with ``scale = 1 / (out / in)``;
    11-bit coefficients ``round(2048 * (1 - f))`` and ``round(2048 * f)``; a
    horizontal pass in int32 whose fraction is 0 at either edge (one tap,
    times 2048, past the last column); a vertical pass whose row indices are
    clamped but whose weights are not, in the arithmetic of cv2's vector code,
    ``(((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``.

``tests/test_torch_transforms.py`` holds it equal to the JAX package's
``KeepRatioResize`` (cv2) over sizes from 1 to 1,500 on each side.  The
training augmentations of that module come with the training pipeline.
"""

from typing import Tuple

import numpy as np


def imrescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmcv.imrescale target size: fit (h, w) inside max/min of ``scale``."""
    max_long, max_short = max(scale), min(scale)
    sf = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * sf + 0.5), int(w * sf + 0.5)


def _coords(n_in: int, n_out: int):
    """cv2's source index and fraction for each output position along one
    axis: float32((x + 0.5) * scale - 0.5), split at its floor."""
    scale = 1.0 / (float(n_out) / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _weights(f: np.ndarray):
    return (np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32),
            np.rint(f * np.float32(2048)).astype(np.int32))


def _bilinear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    # columns: a fraction of 0 at either edge, one tap (times 2048) where the
    # second would fall past the last column
    sx, fx = _coords(w, out_w)
    fx[sx < 0] = 0
    sx[sx < 0] = 0
    one_tap = sx + 1 >= w
    fx[one_tap] = 0
    sx = np.minimum(sx, w - 1)
    a0, a1 = _weights(fx)
    # rows: the weights of the unclamped fraction, both row indices clamped
    sy, fy = _coords(h, out_h)
    b0, b1 = _weights(fy)
    r0 = np.clip(sy, 0, h - 1)
    r1 = np.clip(sy + 1, 0, h - 1)
    # the source rows read, once each; every row flattened to (w * c,) and
    # each output column's samples gathered by one flat index
    rows = np.unique(np.concatenate([r0, r1]))
    c = img.shape[2] if img.ndim == 3 else 1
    flat = img[rows].reshape(len(rows), w * c)
    lane = np.arange(c)
    left = (sx[:, None] * c + lane).ravel()
    right = (np.minimum(sx + 1, w - 1)[:, None] * c + lane).ravel()
    hor = np.take(flat, left, axis=1).astype(np.int32)
    hor *= np.repeat(a0, c)
    tmp = np.take(flat, right, axis=1).astype(np.int32)
    tmp *= np.repeat(a1, c)
    hor += tmp
    hor >>= 4
    out = np.take(hor, np.searchsorted(rows, r0), axis=0)
    out *= b0[:, None]
    out >>= 16
    low = np.take(hor, np.searchsorted(rows, r1), axis=0)
    low *= b1[:, None]
    low >>= 16
    out += low
    out += 2
    out >>= 2
    np.clip(out, 0, 255, out=out)
    return out.astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])


def resize_image(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    for a uint8 image (h, w) or (h, w, c)."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_image takes uint8 images, not {img.dtype}")
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    if (h, w) == (out_h, out_w):
        return img.copy()
    if (h, w) == (2 * out_h, 2 * out_w):
        s = img.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    return _bilinear_u8(img, out_h, out_w)


class KeepRatioResize:
    """Eval resize: deterministic keep-ratio fit into img_scale
    (MultiScaleFlipAug + Resize(keep_ratio=True)).  The segmentation map is
    not resized on the evaluation path (it stays at its original
    resolution), so unlike the JAX package's this takes the image alone."""

    def __init__(self, img_scale: Tuple[int, int]):
        self.img_scale = img_scale

    def __call__(self, img):
        h, w = img.shape[:2]
        return resize_image(img, imrescale_size(h, w, self.img_scale))
