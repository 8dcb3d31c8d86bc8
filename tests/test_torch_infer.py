"""``ifseg_torch.cli.infer`` end to end on the CPU against the JAX package's
``cli/infer.py``: the same PNG, the same flags, the same weights in a
fairseq ``.pt`` file, fp32 at the tiny widths on both sides (each CLI's
``model_config_for_arch`` is wrapped to give them).

Each CLI's dense CRF is wrapped to record what it is given and what it
returns.  Held to each other, for both backends (the port's ``device``
against the JAX ``jax``, ``cpp`` against ``cpp``):

  - the upsampled probabilities before the CRF, to 1e-4 (the full forward,
    the softmax over the ceil-16 grid, label propagation top-5 x 25 and the
    host bilinear upsample, fp32 in another order);
  - the CRF's output, to 1e-4 (``tests/test_torch_crf.py``'s tolerances);
  - the overlay and ``_mask.png`` files, decoded by PIL: equal.

Then ``assets/cat_dog.jpeg`` (a progressive JPEG) through both CLIs with
``--output=*.jpg`` and no CRF: the overlay files are the same bytes (the
port's ``encode_jpeg`` against PIL's ``save``) and the masks the same pixels.
Outputs of other formats raise.
"""

import io

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import ifseg_torch.cli.infer as tinfer
import ifseg_tpu.cli.infer as jinfer
import ifseg_tpu.config as jconfig
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_tpu.checkpoint.convert import flax_to_torch_state_dict
from ifseg_tpu.models.segofa import SegOFAVariables
from ifseg_tpu.ops import crf as jcrf
from ifseg_tpu.ops import crf_jax as jcrf_device

from torch_port_utils import JAX_ONLY, TINY, perturb

CATEGORIES = "cat, dog, grass"
SIZE = 32
DIMS = {k: v for k, v in TINY.items()
        if k not in ("patch_image_size", "orig_patch_image_size", "num_seg_tokens")}


def _tiny(make, **extra):
    return lambda arch, **kw: make(arch, **{**DIMS, **extra, **kw})


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A complete .pt file of perturbed JAX weights at the tiny widths."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    cfg = _tiny(jconfig.model_config_for_arch, **JAX_ONLY)(
        "segofa_tiny", num_seg_tokens=3, patch_image_size=SIZE, orig_patch_image_size=SIZE)
    _, params = SegOFAVariables.init(cfg, jax.random.PRNGKey(5))
    sd = flax_to_torch_state_dict(perturb(params, 5))
    rows, dim = sd["encoder.embed_image_positions.weight"].shape
    sd["decoder.embed_image_positions.weight"] = np.zeros((rows, dim), np.float32)
    torch.save({"model": {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}},
               path)
    return path


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """A 30 x 40 PNG of two colour regions with noise."""
    rng = np.random.default_rng(0)
    rgb = np.zeros((30, 40, 3), np.int64)
    rgb[:, :18] = (200, 40, 30)
    rgb[:, 18:] = (20, 160, 220)
    rgb = np.clip(rgb + rng.integers(-20, 20, size=rgb.shape), 0, 255).astype(np.uint8)
    path = tmp_path_factory.mktemp("img") / "img.png"
    Image.fromarray(rgb).save(path)
    return str(path)


def _recorder(fn, calls):
    def wrapped(image, probs, *args, **kwargs):
        out = fn(image, probs, *args, **kwargs)
        calls.append((np.asarray(probs, np.float32).copy(), np.asarray(out, np.float32).copy()))
        return out

    return wrapped


def _argv(image, checkpoint, bpe_dir, output):
    return [f"--image={image}", f"--checkpoint={checkpoint}", f"--category-list={CATEGORIES}",
            "--arch=segofa_tiny", f"--patch-image-size={SIZE}", f"--bpe-dir={bpe_dir}",
            f"--output={output}", "--crf-iters=5"]


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("backend", ["device", "cpp"])
def test_infer_matches_jax(backend, image, checkpoint, bpe_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")  # leave the JAX cache of the home directory alone
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    # the JAX package builds its C++ CRF into a directory tests/test_crf.py
    # may be building it into at the same time: this test's own instead
    monkeypatch.setattr(jcrf, "_LIB_DIR", str(tmp_path / "lib"))
    monkeypatch.setattr(jcrf, "_LIB_PATH", str(tmp_path / "lib" / "libdensecrf.so"))
    monkeypatch.setattr(jcrf, "_LIB", None)
    jax_calls, torch_calls = [], []
    if backend == "device":
        monkeypatch.setattr(jcrf_device, "dense_crf_jax",
                            _recorder(jcrf_device.dense_crf_jax, jax_calls))
        monkeypatch.setattr(tinfer, "dense_crf_device",
                            _recorder(tinfer.dense_crf_device, torch_calls))
    else:
        monkeypatch.setattr(jcrf, "dense_crf", _recorder(jcrf.dense_crf, jax_calls))
        monkeypatch.setattr(tinfer, "dense_crf", _recorder(tinfer.dense_crf, torch_calls))

    jout, tout = str(tmp_path / "jax.png"), str(tmp_path / "torch.png")
    jinfer.main(_argv(image, checkpoint, bpe_dir, jout)
                + [f"--crf-backend={'jax' if backend == 'device' else 'cpp'}"])
    result = tinfer.main(_argv(image, checkpoint, bpe_dir, tout)
                         + [f"--crf-backend={backend}", "--device=cpu"])

    assert len(jax_calls) == len(torch_calls) == 1
    (jprobs, jrefined), (tprobs, trefined) = jax_calls[0], torch_calls[0]
    assert tprobs.shape == jprobs.shape == (30, 40, 3)
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(trefined, jrefined, atol=1e-4, rtol=0)
    assert result["mask"] == str(tmp_path / "torch_mask.png")
    np.testing.assert_array_equal(_pixels(result["mask"]), _pixels(str(tmp_path / "jax_mask.png")))
    np.testing.assert_array_equal(_pixels(tout), _pixels(jout))
    assert sum(result["areas"].values()) == 30 * 40
    assert set(result["ms"]) >= {"decode", "resize", "forward", "label_propagation", "upsample",
                                 "crf"}


def test_without_a_card_infer_needs_device_cpu(image, checkpoint, bpe_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinfer.main(_argv(image, checkpoint, bpe_dir, str(tmp_path / "o.png")))


def test_jpeg_in_and_out_match_jax(checkpoint, bpe_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    image = str(chip_smoke.REPO / "assets" / "cat_dog.jpeg")
    jout, tout = str(tmp_path / "jax.jpg"), str(tmp_path / "torch.jpg")
    jinfer.main(_argv(image, checkpoint, bpe_dir, jout)[:-1] + ["--crf-iters=0"])
    result = tinfer.main(_argv(image, checkpoint, bpe_dir, tout)[:-1]
                         + ["--crf-iters=0", "--device=cpu"])
    with open(tout, "rb") as a, open(jout, "rb") as b:
        got, want = a.read(), b.read()
    assert got[:3] == b"\xff\xd8\xff" and got == want
    np.testing.assert_array_equal(_pixels(result["mask"]), _pixels(str(tmp_path / "jax_mask.png")))
    assert sum(result["areas"].values()) == 560 * 1440


def test_outputs_are_png_files(image, checkpoint, bpe_dir, tmp_path):
    """Or JPEG files: other formats raise, naming the extension."""
    for name in ("o.bmp", "o.gif", "o"):
        with pytest.raises(ValueError, match="name it \\*.png or \\*.jpg"):
            tinfer.main(_argv(image, checkpoint, bpe_dir, str(tmp_path / name)) + ["--device=cpu"])


def test_colormap_is_the_jax_one():
    np.testing.assert_array_equal(tinfer._colormap(150), jinfer._colormap(150))
