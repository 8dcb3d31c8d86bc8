"""The port's training augmentations (``ifseg_torch/data/transforms.py``)
against the JAX package's cv2-backed ones, bit for bit.

- The colour conversions against ``cv2.cvtColor``, the call the JAX
  module makes: BGR -> HSV over all 2^24 BGR colours, HSV -> BGR over all
  180 x 256 x 256 triples with hue below 180.
- The nearest resize and ``ResizeRatioRange`` against the JAX transforms at
  up- and down-scales, on uint8 and int32.
- ``RandomCrop``, ``RandomFlip`` and ``PhotoMetricDistortion`` against the
  JAX classes with generators of the same seed, over 200 seeds; both
  generators must end in the same state (the same draws, call for call).
"""

import cv2
import numpy as np
import pytest

from ifseg_torch.data import transforms as tt
from ifseg_tpu.data import transforms as jt

SEEDS = range(200)


def test_bgr_to_hsv_equals_cv2_on_every_colour():
    for blue in range(0, 256, 16):  # 16 slabs of 2^20 colours
        c = np.arange(1 << 20, dtype=np.uint32)
        img = np.stack([(c >> 16) + blue, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
        img = img.reshape(1024, 1024, 3)
        assert np.array_equal(tt.bgr_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV)), blue


@pytest.mark.parametrize("width", [256, 1], ids=["vector-blocks", "row-tails"])
def test_hsv_to_bgr_equals_cv2_on_every_triple(width):
    """Rows of 256 pixels go through cv2's vector blocks only, rows of one
    pixel through its per-pixel tail only."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, width, 3)
    assert np.array_equal(tt.hsv_to_bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("width", [1, 7, 31, 32, 33, 40, 95, 512])
def test_colour_round_trip_equals_cv2_at_any_width(width):
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, size=(37, width, 3), dtype=np.uint8)
    hsv = tt.bgr_to_hsv_u8(img)
    assert np.array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    assert np.array_equal(tt.hsv_to_bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("shape,out", [
    ((7, 5), (19, 23)), ((96, 80), (512, 427)), ((300, 260), (150, 130)), ((512, 683), (1024, 1366)),
    ((1024, 1366), (512, 683)), ((33, 1), (1, 33)), ((61, 97), (61, 97)), ((640, 480), (701, 526)),
])
def test_nearest_resize_equals_jax(shape, out, dtype):
    rng = np.random.default_rng(sum(shape) + sum(out))
    x = rng.integers(0, 151, size=shape).astype(dtype)
    got = tt.resize_image(x, out, nearest=True)
    want = jt.resize_image(x, out, nearest=True)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("size", [(96, 80), (300, 260), (375, 500), (1024, 1366)])
def test_resize_ratio_range_equals_jax(size):
    """Image and labels of one row through both ``ResizeRatioRange``s at s
    = 256 and 512: a ratio in [0.5, 2], the short side at least s, so the
    small rows are up-scaled and the large ones down-scaled."""
    for seed in range(12):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, size=size + (3,), dtype=np.uint8)
        seg = rng.integers(0, 151, size=size).astype(np.int32)
        s = (256, 512)[seed % 2]
        tr, jr = (m.ResizeRatioRange((4 * s, s), (0.5, 2.0), min_size=s) for m in (tt, jt))
        ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
        (ti, ts), (ji, js) = tr(img, seg, ga), jr(img, seg, gb)
        assert min(ti.shape[:2]) >= s
        assert np.array_equal(ti, ji) and np.array_equal(ts, js) and ts.dtype == js.dtype
        assert ga.bit_generator.state == gb.bit_generator.state


def _row(seed, size=(96, 80), classes=4):
    """A BGR uint8 image and blocky int32 labels (some crops are one class,
    so the cat_max_ratio retries run)."""
    rng = np.random.default_rng(10_000 + seed)
    img = rng.integers(0, 256, size=size + (3,), dtype=np.uint8)
    seg = np.full(size, rng.integers(0, classes), np.int32)
    for _ in range(rng.integers(0, 4)):
        y, x = rng.integers(0, size[0]), rng.integers(0, size[1])
        seg[y:y + rng.integers(4, 40), x:x + rng.integers(4, 40)] = rng.choice([255, *range(classes)])
    return img, seg


def _same(fn_t, fn_j, seed, *args):
    ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = fn_t(*args, ga), fn_j(*args, gb)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ga.bit_generator.state == gb.bit_generator.state


@pytest.mark.parametrize("crop", [(64, 64), (32, 48)])
def test_random_crop_equals_jax(crop):
    for seed in SEEDS:
        img, seg = _row(seed)
        _same(tt.RandomCrop(crop, cat_max_ratio=0.75), jt.RandomCrop(crop, cat_max_ratio=0.75),
              seed, img, seg)


def test_random_flip_equals_jax():
    for seed in SEEDS:
        img, seg = _row(seed)
        _same(tt.RandomFlip(0.5), jt.RandomFlip(0.5), seed, img, seg)


def test_photometric_distortion_equals_jax():
    for seed in SEEDS:
        img, _ = _row(seed, size=(48, 40))
        _same(tt.PhotoMetricDistortion(), jt.PhotoMetricDistortion(), seed, img)
