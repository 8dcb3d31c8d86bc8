"""The data pipeline's image transforms, in numpy, equal to cv2's.

The JAX package's ``data/transforms.py`` resizes with ``cv2.resize`` and
converts colours with ``cv2.cvtColor`` (mmcv's image ops are cv2-backed).
The port depends on no image library, so this module reproduces what cv2
computes for uint8 images, and for the uint16 images of 16-bit grey rows,
bit for bit.

``resize_image`` with ``INTER_LINEAR`` semantics:

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

``resize_image`` of a uint16 image is not fixed point but float32, in one
of two ways (a big-endian ``>u2`` image is read as cv2 reads it, its bytes
taken in the native order, so each value comes back byte-swapped):

  - from a source of at least 2 x 2 pixels cv2 calls IPP's linear resize:
    source coordinates ``(x + 0.5) * scale - 0.5`` in float64, split at
    their floor, the fraction clamped to 0 at either edge and then made
    float32 (a fraction that rounds up to 1 moves to the next index with
    fraction 0); each pass is one fused multiply-add ``fma(b - a, f, a)``
    in float32, the horizontal pass over the integer samples and the
    vertical one over its float32 results; rounded half to even;
  - from a source one pixel wide or high, cv2's own float path: the uint8
    rule's float32 coordinates and edges, weights ``1 - f`` and ``f`` in
    float32 and each pass ``a * (1 - f) + b * f`` in float32, rounded half
    to even.

``resize_image(..., nearest=True)``, ``INTER_NEAREST``: output x reads source
``min(floor(x * (1 / (out / in))), in - 1)`` in float64, for labels of any
integer dtype (``ops/resize.py``'s nearest rule, which the artificial grids
use, is another one).

``bgr_to_hsv_u8`` and ``hsv_to_bgr_u8``, ``COLOR_BGR2HSV`` and
``COLOR_HSV2BGR`` on 8-bit images (hue 0..179; cv2 refuses a uint16 image
there, and so does ``bgr_to_hsv_u8``, with ``ValueError``):

  - to HSV in integers: ``v = max``, ``diff = max - min``,
    ``s = (diff * sdiv[v] + 2^11) >> 12``, hue from the sector of the maximum
    times ``hdiv[diff]``, rounded the same way, plus 180 when negative;
    ``sdiv[i] = round(255 * 2^12 / i)`` and ``hdiv[i] = round(180 * 2^12 /
    (6 i))``, rounded half to even;
  - back in float32: ``h * (6 / 180)``, ``s * (1 / 255)``, ``v * (1 / 255)``,
    the sector ``floor(h)`` and its fraction f, the four values ``v``,
    ``v (1 - s)``, ``v (1 - s f)``, ``v (1 - s (1 - f))`` with ``1 - s f``
    and ``1 - s (1 - f)`` each one fused multiply-add (cv2 built for AVX2
    with FMA), each channel times 255, truncated in the blocks of 32 pixels
    that cv2's vector code takes from the start of each row and rounded half
    to even in the rest of the row.

``pil_resize`` is PIL's ``Image.resize``, which the serving daemon's request
resize and mask answer use (the JAX package's ``cli/serve.py``), bit for bit
on uint8 images:

  - ``BILINEAR`` is PIL's convolution resampler, not cv2's rule: along each
    axis whose size changes (the horizontal pass first, into uint8), output
    x takes the source pixels within ``support = max(in / out, 1)`` of its
    centre ``(x + 0.5) * in / out`` (bounds rounded by ``int(c -/+ support
    + 0.5)`` and clipped), weighted by the triangle ``1 - |t|`` at ``t = (i -
    centre + 0.5) / max(in / out, 1)`` in float64, normalised, then made
    22-bit fixed point (``int(0.5 + k * 2^22)``); a pixel is ``(2^21 + sum)
    >> 22`` clipped to 0..255;
  - ``NEAREST`` is PIL's affine scale: the source position of output x is
    ``in / out * 0.5`` plus ``in / out`` added x times in float64, truncated
    to an int.

``normalize_image`` is the JAX package's ToTensor + Normalize, NHWC fp32.

The training augmentations of mmseg v0.28 (the reference's
data/mm_data/segmentation_dataset.py:157-173) are the JAX package's:
``ResizeRatioRange``, ``RandomCrop`` with its ``cat_max_ratio`` retries,
``RandomFlip`` and ``PhotoMetricDistortion``, each drawing from the given
``numpy.random.Generator`` call for call in the JAX order, so a row's
augmentation is the JAX package's to the byte.  ``KeepRatioResize`` is the
evaluation resize.  ``tests/test_torch_transforms.py`` and
``tests/test_torch_train_transforms.py`` hold all of it against the JAX
package's cv2 transforms.
"""

from typing import Optional, Tuple

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


def _nearest_source(n_in: int, n_out: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index of each output position along one
    axis: min(floor(x * (1 / (out / in))), in - 1), in float64."""
    ifx = 1.0 / (float(n_out) / n_in)
    return np.minimum(np.floor(np.arange(n_out, dtype=np.float64) * ifx).astype(np.int64),
                      n_in - 1)


def _ipp_axis(n_in: int, n_out: int):
    """IPP's source index and float32 fraction for each output position
    along one axis (see the module docstring)."""
    c = (np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / (float(n_out) / n_in)) - 0.5
    s = np.floor(c).astype(np.int64)
    f = c - s
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= n_in - 1] = 0.0
    s = np.minimum(s, n_in - 1)
    f = f.astype(np.float32)
    up = f == np.float32(1)
    s[up] += 1
    f[up] = 0
    return s, np.minimum(s + 1, n_in - 1), f


def _lerp_fma(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """float32 ``fma(b - a, f, a)``: ``b - a`` rounded to float32, the product
    and sum in 80-bit long double (which hold them whole), rounded once."""
    d = (b - a).astype(np.longdouble)
    d *= f
    d += a
    return d.astype(np.float32)


def _bilinear_u16(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    x = img.astype(np.float32).reshape(h, w, -1)
    if h > 1 and w > 1:  # IPP's linear resize
        x0, x1, fx = _ipp_axis(w, out_w)
        y0, y1, fy = _ipp_axis(h, out_h)
        hor = _lerp_fma(x[:, x0], x[:, x1], fx[None, :, None])
        out = _lerp_fma(hor[y0], hor[y1], fy[:, None, None])
    else:  # cv2's float path
        sx, fx = _coords(w, out_w)
        fx[sx < 0] = 0
        sx[sx < 0] = 0
        edge = sx >= w - 1
        fx[edge] = 0
        sx[edge] = w - 1
        left, right = x[:, sx], x[:, np.minimum(sx + 1, w - 1)]
        hor = left * (np.float32(1) - fx)[None, :, None] + right * fx[None, :, None]
        hor[:, edge] = left[:, edge]
        sy, fy = _coords(h, out_h)
        top, low = hor[np.clip(sy, 0, h - 1)], hor[np.clip(sy + 1, 0, h - 1)]
        out = top * (np.float32(1) - fy)[:, None, None] + low * fy[:, None, None]
    out = np.clip(np.rint(out), 0, 65535).astype(np.uint16)
    return out.reshape((out_h, out_w) + img.shape[2:])


def resize_image(img: np.ndarray, out_hw: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=...)`` for an image
    (h, w) or (h, w, c): ``INTER_LINEAR`` for uint8 or uint16 (a big-endian
    one's bytes read as native, as cv2 reads them), or ``INTER_NEAREST`` (``nearest``) for any
    dtype; an image of the output's size is copied whatever its dtype, as cv2
    copies it, and any other dtype raises ``TypeError``."""
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    if nearest:
        return img[_nearest_source(h, out_h)[:, None], _nearest_source(w, out_w)[None, :]]
    if img.dtype == np.uint16 or img.dtype == np.dtype(">u2"):
        img = img.view(np.uint16).copy()  # cv2 takes a big-endian array's bytes as native
        if (h, w) == (out_h, out_w):
            return img
        return _bilinear_u16(img, out_h, out_w)
    if (h, w) == (out_h, out_w):  # cv2 copies an image of the output's size, whatever its type
        return img.copy()
    if img.dtype != np.uint8:
        # cv2 refuses int32 (a PGM row of more than 8 bits); its float32
        # resize (a PFM row) is IPP's, not reproduced here
        raise TypeError(f"resize_image takes uint8 or uint16 images, not {img.dtype}")
    if (h, w) == (2 * out_h, 2 * out_w):
        s = img.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    return _bilinear_u8(img, out_h, out_w)


PIL_PRECISION_BITS = 22  # PIL's Resample.c: 32 - 8 - 2


def _pil_bilinear_coeffs(n_in: int, n_out: int):
    """PIL's ``precompute_coeffs`` for the bilinear filter, then its 8-bit
    fixed point: (first source index (n_out,), int32 weights (n_out, ksize),
    zero past each output's taps)."""
    scale = float(n_in) / n_out
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n_in) - xmin
    taps = np.arange(ksize)
    t = np.abs(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    k = np.where((taps[None, :] < xmax[:, None]) & (t < 1.0), 1.0 - t, 0.0)
    ww = k.sum(axis=1, keepdims=True)
    k = np.divide(k, ww, out=k, where=ww != 0.0)
    return xmin, (0.5 + k * (1 << PIL_PRECISION_BITS)).astype(np.int32)


def _pil_bilinear_axis(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    n_in = img.shape[axis]
    xmin, k = _pil_bilinear_coeffs(n_in, n_out)
    shape = [1] * img.ndim
    shape[axis] = n_out
    acc = np.full(img.shape[:axis] + (n_out,) + img.shape[axis + 1:],
                  1 << (PIL_PRECISION_BITS - 1), np.int32)
    for tap in range(k.shape[1]):
        src = np.take(img, np.minimum(xmin + tap, n_in - 1), axis=axis).astype(np.int32)
        src *= k[:, tap].reshape(shape)
        acc += src
    acc >>= PIL_PRECISION_BITS  # clip8: a negative sum is 0, 2^30 and up 255
    return np.clip(acc, 0, 255).astype(np.uint8)


def _pil_nearest_source(n_in: int, n_out: int) -> np.ndarray:
    """PIL's affine-scale source index of each output position along one
    axis: in / out * 0.5, plus in / out added once a position, truncated."""
    a = float(n_in) / n_out
    return np.cumsum(np.concatenate([[a * 0.5], np.full(n_out - 1, a)])).astype(np.int64)


def pil_resize(img: np.ndarray, out_hw: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize((out_w, out_h), ...))`` for a
    uint8 image (h, w) or (h, w, 3): ``BILINEAR``, or ``NEAREST``
    (``nearest``)."""
    if img.dtype != np.uint8:
        raise TypeError(f"pil_resize takes uint8 images, not {img.dtype}")
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    if nearest:
        return img[_pil_nearest_source(h, out_h)[:, None], _pil_nearest_source(w, out_w)[None, :]]
    out = img
    if out_w != w:
        out = _pil_bilinear_axis(out, out_w, axis=1)
    if out_h != h:
        out = _pil_bilinear_axis(out, out_h, axis=0)
    return out.copy() if out is img else out


def normalize_image(img_rgb_uint8: np.ndarray, mean, std) -> np.ndarray:
    """ToTensor + Normalize (segmentation_dataset.py:155-156), NHWC fp32."""
    x = img_rgb_uint8.astype(np.float32) / 255.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (x - mean) / std


class ResizeRatioRange:
    """mmseg Resize with ratio_range + min_size, keep_ratio=True.

    Samples ratio ~ U(lo, hi); scale = (img_scale[0]*r, img_scale[1]*r); with
    min_size the scale is replaced by an aspect-exact (new_h, new_w) whose
    short side is max(min(scale), min_size) (mmseg Resize._resize_img).  The
    image is resized bilinearly, the segmentation map by nearest."""

    def __init__(self, img_scale: Tuple[int, int], ratio_range=(0.5, 2.0),
                 min_size: Optional[int] = None):
        self.img_scale = img_scale
        self.ratio_range = ratio_range
        self.min_size = min_size

    def __call__(self, img, seg, rng: np.random.Generator):
        lo, hi = self.ratio_range
        ratio = rng.uniform(lo, hi)
        scale = (int(self.img_scale[0] * ratio), int(self.img_scale[1] * ratio))
        h, w = img.shape[:2]
        if self.min_size is not None:
            new_short = max(min(scale), self.min_size)
            if h > w:
                scale = (new_short * h / w, new_short)
            else:
                scale = (new_short, new_short * w / h)
        out_hw = imrescale_size(h, w, scale)
        return resize_image(img, out_hw), resize_image(seg, out_hw, nearest=True)


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


class RandomCrop:
    """mmseg RandomCrop with cat_max_ratio retry (10 attempts, ignore 255)."""

    def __init__(self, crop_size: Tuple[int, int], cat_max_ratio=0.75, ignore_index=255):
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def _bbox(self, shape, rng):
        margin_h = max(shape[0] - self.crop_size[0], 0)
        margin_w = max(shape[1] - self.crop_size[1], 0)
        oh = rng.integers(0, margin_h + 1)
        ow = rng.integers(0, margin_w + 1)
        return oh, oh + self.crop_size[0], ow, ow + self.crop_size[1]

    def __call__(self, img, seg, rng: np.random.Generator):
        bbox = self._bbox(img.shape, rng)
        if self.cat_max_ratio < 1.0:
            for _ in range(10):
                y1, y2, x1, x2 = bbox
                labels, cnt = np.unique(seg[y1:y2, x1:x2], return_counts=True)
                cnt = cnt[labels != self.ignore_index]
                if len(cnt) > 1 and np.max(cnt) / np.sum(cnt) < self.cat_max_ratio:
                    break
                bbox = self._bbox(img.shape, rng)
        y1, y2, x1, x2 = bbox
        return img[y1:y2, x1:x2], seg[y1:y2, x1:x2]


class RandomFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img, seg, rng: np.random.Generator):
        if rng.uniform() < self.prob:
            img = np.ascontiguousarray(img[:, ::-1])
            seg = np.ascontiguousarray(seg[:, ::-1])
        return img, seg


_HSV_SHIFT = 12
_SDIV = np.rint((255 << _HSV_SHIFT) / np.maximum(np.arange(256), 1.0)).astype(np.int32)
_HDIV180 = np.rint((180 << _HSV_SHIFT) / (6.0 * np.maximum(np.arange(256), 1.0))).astype(np.int32)
_SDIV[0] = _HDIV180[0] = 0
# cv2 converts HSV to BGR a row at a time: blocks of this many pixels in its
# vector code (32 uint8 lanes of AVX2, the build the JAX package's tests run),
# whose products it truncates, then the row's last w % 32 pixels one by one,
# rounded half to even
_CV2_HSV_BLOCK = 32
# (b, g, r) of each hue sector, as indices into (v, v(1-s), v(1-sf), v(1-s(1-f)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` of a uint8 (..., 3) image;
    ValueError for any other dtype, which cv2 refuses too."""
    if img.dtype != np.uint8:
        raise ValueError(f"BGR to HSV takes uint8 images, not {img.dtype} (cv2 refuses it too)")
    bgr = img.astype(np.int32)
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    v = bgr.max(axis=-1)
    diff = v - bgr.min(axis=-1)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` of a uint8 (h, w, 3) image
    with hue in 0..179."""
    f32 = np.float32
    x = hsv.astype(f32)
    h = x[..., 0] * (f32(6.0) / f32(180.0))
    s = x[..., 1] * (f32(1.0) / f32(255.0))
    v = x[..., 2] * (f32(1.0) / f32(255.0))
    sector = np.floor(h)
    h = h - sector
    one = f32(1.0)

    def one_minus_s_times(t):
        """1 - s t rounded once, a fused multiply-add: the fp64 product of
        two fp32 values is exact"""
        return (1.0 - s.astype(np.float64) * t).astype(f32)

    tab = np.stack([v, v * (one - s), v * one_minus_s_times(h),
                    v * one_minus_s_times(one - h)], axis=-1)
    pick = _SECTORS[sector.astype(np.int64) % 6]  # (h, w, 3)
    bgr = np.take_along_axis(tab, pick, axis=-1) * f32(255.0)
    w = hsv.shape[1]
    vector = np.arange(w) < w // _CV2_HSV_BLOCK * _CV2_HSV_BLOCK
    bgr = np.where(vector[:, None], np.trunc(bgr), np.rint(bgr))
    return np.clip(bgr, 0, 255).astype(np.uint8)


class PhotoMetricDistortion:
    """mmseg PhotoMetricDistortion on BGR uint8: random brightness, random
    contrast (before or after), saturation and hue jitter in HSV.  A uint16
    image (a 16-bit grey row) becomes clipped uint8 at its first brightness
    or contrast draw, comes back uint16 with no draw, and raises ValueError
    at a saturation or hue draw that finds it still uint16, as the JAX
    package's cv2 ``cvtColor`` raises."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def _convert(img, alpha=1.0, beta=0.0):
        img = img.astype(np.float32) * alpha + beta
        return np.clip(img, 0, 255).astype(np.uint8)

    def __call__(self, img, rng: np.random.Generator):
        if rng.integers(2):
            img = self._convert(
                img, beta=rng.uniform(-self.brightness_delta, self.brightness_delta))
        mode = rng.integers(2)
        if mode == 1 and rng.integers(2):
            img = self._convert(img, alpha=rng.uniform(self.contrast_lower, self.contrast_upper))
        # saturation
        if rng.integers(2):
            hsv = bgr_to_hsv_u8(img)
            hsv[:, :, 1] = self._convert(
                hsv[:, :, 1], alpha=rng.uniform(self.saturation_lower, self.saturation_upper))
            img = hsv_to_bgr_u8(hsv)
        # hue
        if rng.integers(2):
            hsv = bgr_to_hsv_u8(img)
            hsv[:, :, 0] = (
                hsv[:, :, 0].astype(int) + rng.integers(-self.hue_delta, self.hue_delta + 1)
            ) % 180
            img = hsv_to_bgr_u8(hsv)
        if mode == 0 and rng.integers(2):
            img = self._convert(img, alpha=rng.uniform(self.contrast_lower, self.contrast_upper))
        return img
