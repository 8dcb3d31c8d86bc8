"""float32 images (a PFM row, ROADMAP C.16) through ``data/transforms.py``
against cv2 5.0, bit for bit:

  - ``resize_image`` (``INTER_LINEAR``, IPP's float32 path from a source of
    at least 2 x 2, cv2's own from one a pixel wide or high) of 1-, 3- and
    4-channel images over a sweep of sizes and up and down ratios, values
    of both signs, an infinity, sources one pixel wide or high;
  - the uint16 path, which shares IPP's coordinates, over the same sweep;
  - ``bgr_to_hsv`` and ``hsv_to_bgr`` (``COLOR_BGR2HSV``, ``COLOR_HSV2BGR``)
    of float32 images of every width around cv2's vector block of 8.
"""

import cv2
import numpy as np
import pytest

from ifseg_torch.data.transforms import bgr_to_hsv, hsv_to_bgr, resize_image
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

_SOURCES = [(2, 2), (3, 5), (9, 13), (12, 10), (37, 45), (40, 3), (1, 30), (25, 1)]
_OUTPUTS = [(1, 1), (7, 9), (29, 41), (64, 200), (200, 17), (93, 175)]


def _image(h, w, c, seed):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, c) if c > 1 else (h, w)) * 300 - 20).astype(np.float32)
    if seed % 5 == 0:
        img.reshape(-1)[seed % img.size] = np.inf
    return img


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h,w", _SOURCES, ids=[f"{h}x{w}" for h, w in _SOURCES])
def test_float32_resize_equals_cv2(h, w, c):
    for i, (oh, ow) in enumerate(_OUTPUTS):
        img = _image(h, w, c, seed=h * w * c + i)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got = resize_image(img, (oh, ow))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h,w", _SOURCES, ids=[f"{h}x{w}" for h, w in _SOURCES])
def test_uint16_resize_still_equals_cv2(h, w, c):
    rng = np.random.default_rng(h * w + c)
    for oh, ow in _OUTPUTS:
        img = rng.integers(0, 65536, (h, w, c) if c > 1 else (h, w)).astype(np.uint16)
        np.testing.assert_array_equal(resize_image(img, (oh, ow)),
                                      cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("w", [1, 7, 8, 9, 16, 23, 33])
def test_float32_hsv_round_trip_equals_cv2(w):
    rng = np.random.default_rng(w)
    for scale, grey in ((1.0, False), (300.0, False), (1e-3, False), (300.0, True)):
        img = (rng.random((5, w, 3)) * scale - 20 * (scale > 1)).astype(np.float32)
        if grey:  # a PFM row's BGR: the same value in every channel
            img[:] = img[:, :, :1]
        hsv = bgr_to_hsv(img)
        np.testing.assert_array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        hsv[:, :, 0] = (hsv[:, :, 0].astype(int) + int(rng.integers(-18, 19))) % 180
        np.testing.assert_array_equal(hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
