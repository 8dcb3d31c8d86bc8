"""The port's dense CRFs against the JAX package's, on the CPU.

Each backend is held against its own JAX counterpart, never against the
other backend: the device CRF computes the spatial Gaussian exactly (a
separable convolution) and the C++ one through a lattice, so the two differ
by up to 0.98 in probability on random inputs.

  - ``ops/crf_device.py`` against ``ifseg_tpu/ops/crf_jax.py`` on a 16 x 20
    image of two colour regions, one jitted JAX call for all of it: the
    lattice's vertices, simplex-corner offsets and blur neighbours exactly;
    its barycentric weights and filtered values to 1e-5 of the largest value
    (the elevated coordinates reach about 300, where one float32 ulp is 3e-5
    and moves a weight by up to 5e-6; the JAX package's own jitted and eager
    elevations differ by that ulp); ``spatial_filter`` to 1e-5; 10
    mean-field iterations to 1e-4 and the same labels.
  - ``ops/crf.py`` against ``ifseg_tpu/ops/crf.py``: the same C++ source,
    built here without ``-march=native`` (which lets the compiler fuse
    multiply-adds), so 1e-4 after 10 iterations (the two builds differ by
    about 2.5e-5) and the same labels; the channel-first wrapper likewise.
  - ``ops/build.py`` hashes the host sources' headers, and a failed build of
    ``densecrf.cpp`` raises.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.ops import build
from ifseg_torch.ops import crf as tcrf
from ifseg_torch.ops import crf_device as tdev
from ifseg_tpu.ops import crf as jcrf
from ifseg_tpu.ops import crf_jax as jdev

H, W, C = 16, 20, 3
ITERS = 10


def _two_regions(seed=0):
    """(image_bgr uint8, probs (H, W, C) fp32): two colour regions with a
    little noise, noisy class probabilities."""
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W, 3), np.int64)
    img[:, : W // 2] = (30, 60, 200)
    img[:, W // 2:] = (200, 180, 20)
    img = np.clip(img + rng.integers(0, 12, size=(H, W, 3)), 0, 255).astype(np.uint8)
    probs = rng.dirichlet(np.ones(C), size=(H, W)).astype(np.float32)
    return img, probs


def _bilateral_features(img):
    yy, xx = np.mgrid[0:H, 0:W]
    pos = torch.from_numpy(np.stack([xx.ravel(), yy.ravel()], 1).astype(np.float32))
    col = torch.from_numpy(img.reshape(-1, 3).astype(np.float32))
    return torch.cat([pos / 67.0, col / 3.0], dim=1)


@pytest.fixture(scope="module")
def case():
    img, probs = _two_regions()
    feats = _bilateral_features(img)
    x = np.random.default_rng(1).normal(size=(H * W, C)).astype(np.float32)

    @jax.jit
    def jax_side(feats, x, img, probs):
        off, bary, blur, nv = jdev.build_lattice(feats)
        return dict(off=off, bary=bary, blur=blur, nv=nv,
                    filtered=jdev.lattice_filter(off, bary, blur, x),
                    spatial=jdev.spatial_filter(x, H, W, 1.0),
                    crf=jdev.dense_crf_jax(img, probs, H, W, n_iter=ITERS))

    want = jax.device_get(jax_side(jnp.asarray(feats.numpy()), jnp.asarray(x),
                                   jnp.asarray(img, jnp.float32), jnp.asarray(probs)))
    return dict(img=img, probs=probs, feats=feats, x=x, want=want)


@pytest.fixture(scope="module")
def jax_host_crf(tmp_path_factory):
    """The JAX package's C++ CRF, built into a directory of this module's own
    (its default place is shared with tests/test_crf.py, which may build it
    in another worker at the same time)."""
    saved = jcrf._LIB_DIR, jcrf._LIB_PATH, jcrf._LIB
    lib_dir = tmp_path_factory.mktemp("jax_densecrf")
    jcrf._LIB_DIR, jcrf._LIB_PATH, jcrf._LIB = str(lib_dir), str(lib_dir / "libdensecrf.so"), None
    yield jcrf
    jcrf._LIB_DIR, jcrf._LIB_PATH, jcrf._LIB = saved


def _close_to_largest(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_lattice_matches_jax(case):
    want = case["want"]
    off, bary, blur, nv = tdev.build_lattice(case["feats"])
    assert nv == int(want["nv"])
    np.testing.assert_array_equal(off.numpy(), want["off"])
    # the JAX tables have a slot per simplex corner, "missing" = that count
    slots = H * W * 6
    jblur = np.where(want["blur"][:, :nv] == slots, nv, want["blur"][:, :nv])
    np.testing.assert_array_equal(blur.numpy(), jblur)
    _close_to_largest(bary.numpy(), want["bary"], 1e-5)
    got = tdev.lattice_filter(off, bary, blur, torch.from_numpy(case["x"])).numpy()
    _close_to_largest(got, want["filtered"], 1e-5)


def test_lattice_filter_chunks_the_channels(case, monkeypatch):
    off, bary, blur, _ = tdev.build_lattice(case["feats"])
    x = torch.from_numpy(case["x"])
    whole = tdev.lattice_filter(off, bary, blur, x)
    monkeypatch.setattr(tdev, "_CHUNK_ELEMENTS", H * W * 6)  # one channel a pass
    np.testing.assert_array_equal(tdev.lattice_filter(off, bary, blur, x).numpy(), whole.numpy())


def test_spatial_filter_matches_jax(case):
    got = tdev.spatial_filter(torch.from_numpy(case["x"]), H, W, 1.0).numpy()
    np.testing.assert_allclose(got, case["want"]["spatial"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("caller_allows_tf32", [True, False])
def test_spatial_filter_convolves_in_fp32(case, monkeypatch, caller_allows_tf32):
    """Whatever the caller's cuDNN TF32 setting, the two convolutions run with
    TF32 off, and the caller's setting is back afterwards."""
    seen = []
    conv2d = tdev.F.conv2d

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(tdev.F, "conv2d", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", caller_allows_tf32)
    tdev.spatial_filter(torch.from_numpy(case["x"]), H, W, 1.0)
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32 is caller_allows_tf32


def test_dense_crf_device_matches_jax(case):
    got = tdev.dense_crf_device(torch.from_numpy(case["img"]), torch.from_numpy(case["probs"]),
                                n_iter=ITERS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (H, W, C)
    want = case["want"]["crf"]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_device_crf_refuses_a_lattice_too_wide_to_pack():
    feats = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0], [1e5, 1e5, 1e5, 1e5, 1e5]])
    with pytest.raises(ValueError, match="too wide"):
        tdev.build_lattice(feats)


def test_host_crf_matches_jax(case, jax_host_crf):
    img, probs = case["img"], case["probs"]
    got = tcrf.dense_crf(img, probs, n_iter=ITERS)
    want = jax_host_crf.dense_crf(img, probs, n_iter=ITERS)
    assert got.dtype == np.float32 and got.shape == (H, W, C)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("channel_first", [True, False], ids=["CHW", "HWC"])
def test_rgb_dense_crf_layouts(case, jax_host_crf, channel_first):
    img, probs = case["img"], case["probs"]
    p = probs.transpose(2, 0, 1) if channel_first else probs
    got = tcrf.rgb_dense_crf(img, p, max_iter=3)
    want = jax_host_crf.rgb_dense_crf(img, p, max_iter=3)
    assert got.shape == p.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_host_crf_checks_shapes(case):
    with pytest.raises(ValueError, match="does not match"):
        tcrf.dense_crf(case["img"][:, :-1], case["probs"])


def test_host_source_hash_covers_its_headers(tmp_path, monkeypatch):
    """An edited header gives ``densecrf.cpp`` another library path, so the
    old library is never loaded for it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path("densecrf")
    assert before == build.library_path("densecrf")
    header = csrc / "permutohedral.h"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path("densecrf") != before


def test_a_failed_densecrf_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="build failed for densecrf"):
        build.load("densecrf")
    assert not list(tmp_path.glob("*.so"))
