"""The port's padded native-resolution forward against the JAX package's,
and against the port's own exact-shape forward (CPU, fp32).

Tolerance 2e-4 (atol and rtol), the bound ``tests/test_eval_padded.py`` holds
the JAX padded forward to against its exact one: both sides compute in fp32
and differ in summation order.  Both branches of the position and bias
construction are run: direct lookups (valid grid no larger than the
pretraining grid) and interpolation (larger).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ifseg_tpu.models.resnet import ResNetStem as JaxStem
from ifseg_tpu.models.segofa import SegOFA as JaxSegOFA

from torch_port_utils import make_pair

TOL = dict(atol=2e-4, rtol=2e-4)
BRANCHES = [
    ((48, 64), (96, 96)),   # 3x4 = 12 <= 16 grid cells: direct lookups
    ((80, 80), (96, 128)),  # 5x5 = 25 > 16: interpolation
]


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0)


def _padded_inputs(hw, pad_hw, batch=1, seed=0):
    h, w = hw
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(batch, h, w, 3)).astype(np.float32)
    padded = np.zeros((batch, *pad_hw, 3), np.float32)
    padded[:, :h, :w] = img
    src = rng.integers(4, 100, size=(batch, 10)).astype(np.int32)
    src[-1, 7:] = 1  # PAD
    bos = np.zeros((batch, 1), np.int32)
    return img, padded, src, bos


def _valid_grid(logits, pad_hw, hw):
    """(BOS row, valid grid rows) of padded logits (B, 1 + Hp*Wp, C)."""
    gh, gw = pad_hw[0] // 16, pad_hw[1] // 16
    hp, wp = -(-hw[0] // 16), -(-hw[1] // 16)
    grid = logits[:, 1: 1 + gh * gw].reshape(logits.shape[0], gh, gw, -1)
    return logits[:, 0], grid[:, :hp, :wp]


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-extents", "per-row-extents"])
def test_stem_valid_hw_matches_jax(pair, per_row):
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(2)
    # per-row extents share their ceil-16 extents (3, 5), as an eval group's do
    extents = [(48, 80), (45, 77), (47, 79)] if per_row else [(48, 80)] * 2
    x = np.zeros((len(extents), 64, 128, 3), np.float32)
    for i, (h, w) in enumerate(extents):
        x[i, :h, :w] = rng.normal(size=(h, w, 3))
    vh = np.array([e[0] for e in extents], np.int32)
    vw = np.array([e[1] for e in extents], np.int32)
    jvalid = (jnp.asarray(vh), jnp.asarray(vw)) if per_row else (jnp.int32(48), jnp.int32(80))
    tvalid = (torch.from_numpy(vh), torch.from_numpy(vw)) if per_row else (48, 80)

    stem = JaxStem(layers=(3, 4, 6), dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda p, im, v: stem.apply({"params": p}, im, valid_hw=v))(
        params["encoder"]["embed_images"], jnp.asarray(x), jvalid))
    with torch.no_grad():
        got = tmodel.encoder.embed_images(torch.from_numpy(x), valid_hw=tvalid).numpy()
    assert got.shape == want.shape == (len(extents), 4, 8, 1024)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[:, 3:].any() and not got[:, :, 5:].any()  # the padded cells are exactly 0
    assert np.abs(got[:, :3, :5]).max() > 0.1


def test_stem_padded_equals_unpadded_within_the_port(pair):
    _, _, tmodel = pair
    img, padded, _, _ = _padded_inputs((48, 64), (96, 96), seed=3)
    stem = tmodel.encoder.embed_images
    with torch.no_grad():
        exact = stem(torch.from_numpy(img))
        masked = stem(torch.from_numpy(padded), valid_hw=(48, 64))
        unmasked = stem(torch.from_numpy(padded))
    np.testing.assert_allclose(masked[:, :3, :4].numpy(), exact.numpy(), atol=1e-5, rtol=1e-5)
    # without the masks the folded BN shift leaks from the pad into the border cells
    assert (unmasked[:, :3, :4] - exact).abs().max() > 1e-3


@pytest.mark.parametrize("hw,pad_hw", BRANCHES, ids=["gather", "interpolation"])
def test_eval_forward_matches_jax(pair, hw, pad_hw):
    jmodel, params, tmodel = pair
    _, padded, src, bos = _padded_inputs(hw, pad_hw, batch=2)
    h, w = hw

    def f(p, s, im, bo, hh, ww):
        return jmodel.apply({"params": p}, s, im, hh, ww, bo, False,
                            method=JaxSegOFA.eval_forward)

    want, want_enc = jax.jit(f)(params, jnp.asarray(src), jnp.asarray(padded), jnp.asarray(bos),
                                jnp.int32(h), jnp.int32(w))
    with torch.no_grad():
        got, enc = tmodel.eval_forward(torch.from_numpy(src).long(), torch.from_numpy(padded),
                                       h, w, torch.from_numpy(bos).long())
    assert enc["image_embed_shape"] == (pad_hw[0] // 16, pad_hw[1] // 16)
    assert enc["valid_hw"] == (-(-h // 16), -(-w // 16))
    assert np.array_equal(enc["grid_valid"].numpy(), np.asarray(want_enc["grid_valid"]))
    assert np.array_equal(enc["encoder_padding_mask"].numpy(),
                          np.asarray(want_enc["encoder_padding_mask"]))
    np.testing.assert_allclose(enc["position_embeddings"].numpy(),
                               np.asarray(want_enc["position_embeddings"]), **TOL)
    np.testing.assert_allclose(enc["image_embed_before_proj"].numpy(),
                               np.asarray(want_enc["image_embed_before_proj"]), **TOL)
    # the valid region; padded cells hold values nobody reads
    for a, b in zip(_valid_grid(got.numpy(), pad_hw, hw), _valid_grid(np.asarray(want), pad_hw, hw)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize(
    "hw,pad_hw,zero_image_tables",
    [((64, 64), (96, 96), False), ((80, 80), (96, 128), False), ((48, 64), (96, 96), True)],
    ids=["gather", "interpolation", "gather-smaller-grid"],
)
def test_padded_matches_exact_within_the_port(pair, hw, pad_hw, zero_image_tables):
    """The exact forward is ``SegOFA.forward`` on the unpadded image.  For a
    grid smaller than the pretraining grid the two differ by design, in the
    JAX package too: ``encode`` resizes the image relative bias down from the
    pretraining grid where ``encode_padded`` looks the cells up directly.  So
    the direct branch is held at the pretraining grid itself, and at a
    smaller grid with the image relative tables zeroed (as a fresh JAX init
    has them), which leaves every other part of the padded forward."""
    import copy

    tmodel = pair[2]
    if zero_image_tables:
        tmodel = copy.deepcopy(tmodel)
        with torch.no_grad():
            for table in tmodel.encoder.image_rel_pos_table_list:
                table.weight.zero_()
    img, padded, src, bos = _padded_inputs(hw, pad_hw)
    src, bos = torch.from_numpy(src).long(), torch.from_numpy(bos).long()
    with torch.no_grad():
        exact, _ = tmodel(src_tokens=src, patch_images=torch.from_numpy(img), bos_tokens=bos)
        got, _ = tmodel.eval_forward(src, torch.from_numpy(padded), hw[0], hw[1], bos)
    hp, wp = -(-hw[0] // 16), -(-hw[1] // 16)
    bos_row, grid = _valid_grid(got.numpy(), pad_hw, hw)
    np.testing.assert_allclose(grid, exact[:, 1: 1 + hp * wp].reshape(1, hp, wp, -1).numpy(), **TOL)
    np.testing.assert_allclose(bos_row, exact[:, 0].numpy(), **TOL)


def test_per_row_extents_match_single_rows(pair):
    """Rows with different pixel extents and the same ceil-16 extents in one
    batch give what each gives alone."""
    _, _, tmodel = pair
    rng = np.random.default_rng(5)
    extents = [(48, 80), (45, 77), (47, 79)]
    padded = np.zeros((3, 64, 128, 3), np.float32)
    for i, (h, w) in enumerate(extents):
        padded[i, :h, :w] = rng.normal(size=(h, w, 3))
    src = torch.from_numpy(rng.integers(4, 100, size=(3, 10))).long()
    bos = torch.zeros(3, 1, dtype=torch.long)
    x = torch.from_numpy(padded)
    with torch.no_grad():
        both, _ = tmodel.eval_forward(src, x, np.array([e[0] for e in extents]),
                                      np.array([e[1] for e in extents]), bos)
        for i, (h, w) in enumerate(extents):
            one, _ = tmodel.eval_forward(src[i: i + 1], x[i: i + 1], h, w, bos[i: i + 1])
            for a, b in zip(_valid_grid(both[i: i + 1].numpy(), (64, 128), (h, w)),
                            _valid_grid(one.numpy(), (64, 128), (h, w))):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
