"""16-bit grey dataset rows ("I;16" PNG, "I;16"/"I;16B" TIFF) in the port
against the JAX package, which keeps them uint16 through cv2:

  - ``resize_image`` of uint16 images against ``cv2.resize(INTER_LINEAR)``,
    bit for bit: odd and even sizes, up and down, the exact 2x down-scale,
    sources one pixel wide or high, 1 and 3 channels, big-endian input
    (whose bytes cv2 reads as native);
  - ``PhotoMetricDistortion`` on uint16 images at a spread of seeds: the
    JAX array where the JAX one returns, a raise where it raises (cv2's
    ``cvtColor`` refuses uint16);
  - ``get_train_example`` and ``get_eval_sample`` on the rows, and the
    evaluator's areas of the uint16 sample at the tiny width; a group
    mixing uint8 and uint16 samples fails in both.
"""

import base64

import numpy as np
import pytest
from PIL import Image

import ifseg_torch.eval.evaluator as tev
import ifseg_tpu.eval.evaluator as jev
import torch_image_writers as W
from ifseg_torch.data import transforms as tt
from ifseg_torch.data.image import decode_image
from ifseg_tpu.data import transforms as jt

from test_torch_cut_files import _datasets
from test_torch_evaluator import AREAS, ListDS, _assert_same, _evaluators, pair  # noqa: F401
from utils import png_b64
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

_SIZES = [((37, 45), (23, 61)), ((64, 48), (32, 24)), ((17, 9), (40, 33)),
          ((100, 131), (77, 200)), ((300, 41), (129, 90)), ((1, 7), (5, 3)),
          ((9, 1), (2, 6)), ((2, 2), (1, 1)), ((40, 40), (40, 40)), ((210, 234), (434, 279)),
          ((683, 512), (1366, 1024)), ((1366, 1024), (512, 384))]


@pytest.mark.parametrize("shape,out", _SIZES)
def test_resize_u16_equals_cv2(shape, out):
    rng = np.random.default_rng(sum(shape) + sum(out))
    for c in (1, 3):
        img = rng.integers(0, 65536, shape + ((3,) if c == 3 else ())).astype(np.uint16)
        for src in (img, img.astype(">u2")):
            want = jt.resize_image(src, out)
            got = tt.resize_image(src, out)
            assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_resize_u16_seeded_grid_equals_cv2():
    rng = np.random.default_rng(11)
    for h, w, oh, ow in rng.integers(1, 120, (80, 4)):
        img = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
        np.testing.assert_array_equal(tt.resize_image(img, (oh, ow)),
                                      jt.resize_image(img, (int(oh), int(ow))))


def _call(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # cv2.error on the JAX side, ValueError on the port's
        return e


def test_photometric_distortion_on_uint16_equals_jax():
    img = np.random.default_rng(3).integers(0, 65536, (13, 21, 3)).astype(np.uint16)
    outcomes = set()
    for seed in range(40):
        got = _call(tt.PhotoMetricDistortion(), img, np.random.default_rng(seed))
        want = _call(jt.PhotoMetricDistortion(), img, np.random.default_rng(seed))
        if isinstance(want, Exception):
            assert isinstance(got, ValueError), seed
            outcomes.add("raise")
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), seed
            outcomes.add(str(want.dtype))
    assert outcomes == {"raise", "uint8", "uint16"}


def _rows16():
    """An "I;16" PNG, an "I;16" TIFF and an "I;16B" TIFF, smooth 16-bit grey."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 65536, (14, 17)).astype(np.uint16)
    grey = np.repeat(np.repeat(base, 5, 0), 5, 1)[:67, :81]
    png = W.pil_save(Image.fromarray(grey), "PNG")
    tif = W.pil_save(Image.fromarray(grey[:, :75]), "TIFF")
    tif_be = W.tiff_file(grey[:59], 16, 1, "MM")
    modes = [decode_image(d)[1] for d in (png, tif, tif_be)]
    assert modes == ["I;16", "I;16", "I;16B"]
    return [png, tif, tif_be]


def _tsv(path, extra=()):
    rng = np.random.default_rng(6)
    with open(path, "w") as fp:
        for i, data in enumerate(_rows16() + list(extra)):
            h, w = decode_image(data)[0].shape[:2]
            seg = rng.integers(0, 4, (h, w)).astype(np.uint8)
            fp.write(f"{base64.urlsafe_b64encode(data).decode()}\t{png_b64(seg)}\t{i}\n")
    return str(path)


def test_train_examples_of_16bit_rows_equal_jax(tmp_path, bpe_dir):
    got_ds, want_ds = _datasets(_tsv(tmp_path / "r.tsv"), bpe_dir, "train")
    outcomes = set()
    for i in range(len(want_ds)):
        for seed in range(12):
            ga, gb = np.random.default_rng((9, i, seed)), np.random.default_rng((9, i, seed))
            want = _call(want_ds.get_train_example, i, gb)
            got = _call(got_ds.get_train_example, i, ga)
            if isinstance(want, Exception):
                assert isinstance(got, ValueError), (i, seed)
                outcomes.add("raise")
                continue
            assert got.keys() == want.keys()
            for k in want:
                if k != "id":
                    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), \
                        (i, seed, k)
            outcomes.add(str(want["patch_image"].dtype))
            assert ga.bit_generator.state == gb.bit_generator.state
    assert outcomes == {"raise", "uint8", "uint16"}


def test_eval_samples_of_16bit_rows_equal_jax(tmp_path, bpe_dir, pair, monkeypatch):  # noqa: F811
    for mod in (tev, jev):
        monkeypatch.setattr(mod, "BUCKET", 64)
        monkeypatch.setattr(mod, "ROW_CHUNK", 32)
    got_ds, want_ds = _datasets(_tsv(tmp_path / "r.tsv"), bpe_dir, "valid")
    jevr, params, tevr = _evaluators(pair)
    for i in range(len(want_ds)):
        got, want = got_ds.get_eval_sample(i), want_ds.get_eval_sample(i)
        assert got.patch_image.dtype == want.patch_image.dtype == np.uint16
        np.testing.assert_array_equal(got.patch_image, want.patch_image)
        np.testing.assert_array_equal(got.ori_semantic_seg, want.ori_semantic_seg)
        # the sample at the tiny width (its grid fits the 4 x 4 pretraining grid)
        small = lambda s: s.__class__(**dict(vars(s), patch_image=s.patch_image[:40, :48]))
        _assert_same(tevr.eval_sample(small(got)), jevr.eval_sample(params, small(want)), AREAS)


def test_mixed_uint8_uint16_group_fails_as_jax(tmp_path, bpe_dir, pair, monkeypatch):  # noqa: F811
    for mod in (tev, jev):
        monkeypatch.setattr(mod, "BUCKET", 64)
        monkeypatch.setattr(mod, "ROW_CHUNK", 32)
    rgb = np.random.default_rng(1).integers(0, 256, (67, 81, 3)).astype(np.uint8)
    tsv = _tsv(tmp_path / "r.tsv", [W.pil_save(Image.fromarray(rgb), "PNG")])
    got_ds, want_ds = _datasets(tsv, bpe_dir, "valid")
    jevr, params, tevr = _evaluators(pair)
    shrink = lambda s: s.__class__(**dict(vars(s), patch_image=s.patch_image[:40, :48]))
    with pytest.raises(AssertionError, match="mixed patch_image dtypes"):
        jevr.eval_dataset(params, ListDS([shrink(want_ds.get_eval_sample(i)) for i in (0, 3)]),
                          batch_size=2)
    with pytest.raises(AssertionError, match="mixed patch_image dtypes"):
        tevr.eval_dataset(ListDS([shrink(got_ds.get_eval_sample(i)) for i in (0, 3)]),
                          batch_size=2)
