"""The port's keep-ratio evaluation resize against the JAX package's, which
calls ``cv2.resize(..., INTER_LINEAR)``: equal bit for bit on uint8 BGR
images of every size from 1 to 1,500 on each side, through each branch cv2
takes (a copy at equal size, its area average at an exact 2x down-scale, the
fixed-point bilinear otherwise, up and down).
"""

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

from ifseg_torch.data import transforms as tt
from ifseg_tpu.data import transforms as jt

BOX = (2048, 512)  # (4s, s) at patch_image_size 512


def _image(h, w, seed, c=3):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, c), dtype=np.uint8)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 1500), st.integers(1, 1500), st.integers(0, 2**16))
@example(512, 683, 0)  # equal size: a copy
@example(1024, 1366, 1)  # exact 2x: cv2's area average
@example(480, 640, 2)  # up-scale
@example(375, 500, 3)  # up-scale
@example(600, 800, 4)  # down-scale
@example(640, 480, 5)  # portrait
@example(1, 1, 6)
@example(1, 1500, 7)
@example(1500, 1, 8)
@example(2, 3, 9)
def test_keep_ratio_resize_equals_cv2(h, w, seed):
    img = _image(h, w, seed)
    want, _ = jt.KeepRatioResize(BOX)(img)
    got = tt.KeepRatioResize(BOX)(img)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,out", [((40, 60), (40, 60)), ((40, 60), (20, 30)),
                                       ((40, 60), (97, 31)), ((33, 17), (8, 5)),
                                       ((1, 7), (5, 1)), ((300, 2), (3, 700))])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_image_equals_cv2(shape, out, channels):
    img = _image(*shape, seed=sum(shape), c=channels)
    img = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(tt.resize_image(img, out), jt.resize_image(img, out))


def test_imrescale_size_equals_jax():
    rng = np.random.default_rng(0)
    for h, w in rng.integers(1, 3000, size=(500, 2)):
        assert tt.imrescale_size(int(h), int(w), BOX) == jt.imrescale_size(int(h), int(w), BOX)


def test_resize_takes_uint8_only():
    with pytest.raises(TypeError, match="uint8"):
        tt.resize_image(np.zeros((4, 4, 3), np.float32), (8, 8))
