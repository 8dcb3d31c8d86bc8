"""PIL 12.1's ``convert("RGB")`` of a "LAB" image: LittleCMS 2.17's transform
from its built-in Lab profile (D50, the V2 identity) to its built-in sRGB,
perceptual intent, 8 bits in and out, as ``ImageCms.buildTransform`` makes it
for PIL, bit for bit (every one of the 2 ** 24 inputs).

What LittleCMS builds there: the pipeline Lab (V4 rules: L = 100 v, a and b =
255 v - 128) to XYZ under D50, divided by 1 + 32767 / 32768; the inverse of
the sRGB profile's colorant matrix (Rec. 709 primaries and the D65 white,
adapted to D50 by Bradford), times 1 + 32767 / 32768; the inverse of the
sRGB curve.  Its optimiser samples that pipeline on a grid of 33 x 33 x 33
nodes in 16 bits (float32 between the stages, doubles inside them, each node
rounded with LittleCMS's ``_cmsQuickSaturateWord``); a transform then reads
each input byte as ``v * 257``, interpolates the grid tetrahedrally in 16.16
fixed point and writes ``(v * 65281 + 2 ** 23) >> 24``.  PIL hands LittleCMS
its own storage of the image, whose a and b bytes are the array's with the
top bit flipped.

``lab_to_rgb(pixels)`` takes the (h, w, 3) uint8 array that
``np.asarray`` of PIL's "LAB" image gives; the grid is computed here once
with numpy and the interpolation runs in ``csrc/png_unfilter.cpp``.
"""

from functools import lru_cache

import numpy as np

from ifseg_torch.data import png

_XYZ_MAX = 1.0 + 32767.0 / 32768.0  # LittleCMS's MAX_ENCODEABLE_XYZ
_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
_GRID = 33  # _cmsReasonableGridpointsByColorspace for three channels
# the sRGB curve's parameters: gamma, a, b, c, d (IEC 61966-2.1)
_G, _A, _B, _C, _D = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045


def _inverse(a):
    """LittleCMS's ``_cmsMAT3inverse``, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return ((c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
            (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
            (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _product(a, b):
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
                       for j in range(3)) for i in range(3))


def _apply(a, v):
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3))


def _srgb_to_xyz_d50():
    """The sRGB profile's colorants: ``_cmsBuildRGB2XYZtransferMatrix`` with
    the Bradford adaptation of D65 to D50."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inverse(((xr, xg, xb), (yr, yg, yb), (1 - xr - yr, 1 - xg - yg, 1 - xb - yb))),
                  (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    rgb_xyz = ((coef[0] * xr, coef[1] * xg, coef[2] * xb),
               (coef[0] * yr, coef[1] * yg, coef[2] * yb),
               (coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)))
    white = ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0)
    src, dst = _apply(_BRADFORD, white), _apply(_BRADFORD, _D50)
    cone = ((dst[0] / src[0], 0.0, 0.0), (0.0, dst[1] / src[1], 0.0), (0.0, 0.0, dst[2] / src[2]))
    adapt = _product(_inverse(_BRADFORD), _product(cone, _BRADFORD))
    return _product(adapt, rgb_xyz)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """``_cmsQuickSaturateWord``: + 0.5, clamped, floored at 2 ** -16
    resolution (the magic-number floor)."""
    d = np.asarray(d, np.float64) + 0.5
    magic = 68719476736.0 * 1.5
    floor = np.floor(((d - 32767.0) + magic) - magic) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.uint16)


@lru_cache(maxsize=None)
def grid() -> np.ndarray:
    """(33, 33, 33, 3) uint16 nodes, indexed L, a, b."""
    inv = _inverse(_srgb_to_xyz_d50())
    inv = [[inv[i][j] * _XYZ_MAX for j in range(3)] for i in range(3)]
    q = _saturate_word(np.arange(_GRID, dtype=np.float64) * 65535.0 / (_GRID - 1))
    axes = np.meshgrid(q, q, q, indexing="ij")
    v = [(x.astype(np.float64) / 65535.0).astype(np.float32).astype(np.float64) for x in axes]
    y = (v[0] * 100.0 + 16.0) / 116.0
    t = (y + 0.002 * (v[1] * 255.0 - 128.0), y, y - 0.005 * (v[2] * 255.0 - 128.0))
    xyz = [np.where(t[k] <= 24.0 / 116.0, (108.0 / 841.0) * (t[k] - 16.0 / 116.0),
                    t[k] * t[k] * t[k]) * _D50[k] / _XYZ_MAX for k in range(3)]
    xyz = [c.astype(np.float32).astype(np.float64) for c in xyz]
    out = []
    for i in range(3):
        lin = ((xyz[0] * inv[i][0] + xyz[1] * inv[i][1]) + xyz[2] * inv[i][2])
        lin = lin.astype(np.float32).astype(np.float64)
        high = lin >= (_A * _D + _B) ** _G
        curve = np.where(high, (np.power(np.where(high, lin, 1.0), 1.0 / _G) - _B) / _A, lin / _C)
        out.append(_saturate_word(curve.astype(np.float32).astype(np.float64) * 65535.0))
    return np.ascontiguousarray(np.stack(out, -1).reshape(_GRID, _GRID, _GRID, 3))


def lab_to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 RGB of an (h, w, 3) uint8 "LAB" array, as PIL's
    ``convert("RGB")`` gives it."""
    stored = np.ascontiguousarray(pixels, np.uint8) ^ np.array([0, 128, 128], np.uint8)
    out = np.empty(stored.shape[:2] + (3,), np.uint8)
    png._lib().lab_to_rgb(stored.ctypes.data, out.ctypes.data, stored.shape[0] * stored.shape[1],
                          grid().ctypes.data, _GRID)
    return out
