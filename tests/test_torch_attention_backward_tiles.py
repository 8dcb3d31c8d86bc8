"""The port's plain attention backward at the edges of the Hopper backward
kernels' tiles, and the row-padded bias packs that let those kernels fetch
every bias by TMA.

The dq + dbias kernel works on 128 query rows (64 a consumer warpgroup) and
64-key stages, the dk + dv kernel on 128 keys (64 a consumer) and 64-row
query stages; both take the bias by TMA only, so the backward row-pads a bias
whose rows are not 16-byte aligned, and the models build their in-graph packs
row-padded.  The kernels are held against the plain backward on the card, so
here the plain backward is held against the JAX package's ``_flash_backward``
(Pallas, interpret mode, on the CPU) where those tiles end: lengths of 1, 63,
64, 65, 127, 128, 129 and 257, causal with the offset Lk − Lq, a key mask that
pads a whole 128-key tile, a bf16 or fp32 bias, or none.

Tolerances as in ``test_torch_attention_backward.py``: 2e-4 (atol and rtol;
both sides accumulate in fp32 and differ in summation order), one bf16 ulp
for a bf16 dbias (both round the same fp32 sum once).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ifseg_tpu.ops.flash_attention as jfa
from ifseg_torch.models import attention as tattention
from ifseg_torch.ops import flash_attention as tfa

from torch_port_utils import class_table, torch_tiny, train_batch

TOL = 2e-4
BF16_ULP = 2 ** -7


@pytest.fixture(autouse=True)
def force_interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _inputs(b, h, lq, lk, d, mask_kind, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h * d)).astype(np.float32) * 0.3
    k = rng.normal(size=(b, lk, h * d)).astype(np.float32) * 0.3
    v = rng.normal(size=(b, lk, h * d)).astype(np.float32)
    bias = rng.normal(size=(h, lq, lk)).astype(np.float32)
    g = rng.normal(size=(b, lq, h * d)).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = np.zeros((b, lk), bool)
        mask[-1, max(lk - 5, 1):] = True  # key 0 stays visible: no fully masked row
        if mask_kind == "tile":  # keys 128..255: a whole key tile of either kernel, padded
            mask[:, 128:256] = True
    return q, k, v, bias, g, mask


# (Lq, Lk, causal, key mask): every length of {1, 63, 64, 65, 127, 128, 129,
# 257} on both sides, causal only with Lk >= Lq (offset Lk - Lq)
EDGES = {
    "1x1-causal": (1, 1, True, None),
    "1x257-mask": (1, 257, False, "tail"),
    "63x64-causal": (63, 64, True, "tail"),
    "64x63": (64, 63, False, None),
    "65x129-causal-mask": (65, 129, True, "tail"),
    "127x128-causal": (127, 128, True, None),
    "128x127-mask": (128, 127, False, "tail"),
    "129x65": (129, 65, False, None),
    "129x257-causal-padded-tile": (129, 257, True, "tile"),
    "257x257-causal-padded-tile": (257, 257, True, "tile"),
    "257x129-mask": (257, 129, False, "tail"),
    "65x257-padded-tile": (65, 257, False, "tile"),
}
BIASES = ["fp32", "bf16", None]


@pytest.mark.parametrize("bias_dtype", BIASES, ids=["fp32-bias", "bf16-bias", "no-bias"])
@pytest.mark.parametrize("edge", list(EDGES))
def test_plain_backward_matches_pallas_at_tile_edges(edge, bias_dtype):
    lq, lk, causal, mask_kind = EDGES[edge]
    b, h, d = 2, 2, 64
    q, k, v, bias, g, mask = _inputs(b, h, lq, lk, d, mask_kind, seed=lq * 1000 + lk)
    jbias = {None: None, "fp32": jnp.asarray(bias),
             "bf16": jnp.asarray(bias, jnp.bfloat16)}[bias_dtype]
    tbias = {None: None, "fp32": torch.from_numpy(bias),
             "bf16": torch.from_numpy(bias).bfloat16()}[bias_dtype]
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))

    jout, jlse = jfa.flash_attention_bias_packed_stats(jq, jk, jv, jbias, jmask, causal, h)
    jdq, jdk, jdv, jdb = jfa._flash_backward(
        jq, jk, jv, jbias, jmask, causal, jg, jout, jlse, num_heads=h)
    out, lse = tfa.attention_bias_stats_reference(tq, tk, tv, tbias, tmask, causal, h)
    dq, dk, dv, db = tfa.attention_bias_backward_reference(
        tq, tk, tv, tbias, tmask, causal, tg, out, lse, h)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    if bias_dtype is None:
        assert db is None and jdb is None
        return
    assert db.dtype == tbias.dtype and tuple(db.shape) == (h, lq, lk)
    tol = TOL if bias_dtype == "fp32" else BF16_ULP
    np.testing.assert_allclose(db.float().numpy(), np.asarray(jdb.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("lq,lk,causal", [(65, 129, True), (129, 257, False), (63, 63, True)],
                         ids=["65x129-causal", "129x257", "63x63-causal"])
def test_row_padded_bias_leaf_gives_the_dense_gradients(lq, lk, causal, dtype):
    """On the CPU the Function gives the same out, dq, dk, dv and dbias for a
    bias leaf that is a view of row-padded storage as for the dense bias, and
    dbias has the bias's shape (H, Lq, Lk) and dtype."""
    b, h, d = 2, 2, 64
    q, k, v, bias, g, mask = _inputs(b, h, lq, lk, d, "tile", seed=lq + lk)
    tmask = torch.from_numpy(mask)
    dense = torch.from_numpy(bias).to(dtype)
    padded = tfa.row_padded(dense)
    assert padded.stride(1) % 8 == 0 and torch.equal(padded, dense)
    results = []
    for bias_leaf in (dense.clone(), padded.detach()):
        leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
        bias_leaf.requires_grad_(True)
        out, _ = tfa.flash_attention_bias_packed_stats(*leaves, bias_leaf, tmask, causal, h)
        out.backward(torch.from_numpy(g).to(dtype))
        assert bias_leaf.grad.shape == (h, lq, lk) and bias_leaf.grad.dtype == dtype
        results.append([out.detach()] + [x.grad for x in leaves + [bias_leaf]])
    for a, c in zip(*results):
        assert torch.equal(a, c)


def test_backward_row_pads_only_what_tma_cannot_take():
    """``row_padded``, which the backward applies to its bias, returns a bias
    that is already row-padded, or dense with 16-byte rows, as it is; any
    other (an odd key count, a start 2 bytes off) becomes a padded copy."""
    h, lq = 2, 5
    padded = tfa.row_padded(torch.randn(h, lq, 65).bfloat16())
    aligned_bf16 = torch.randn(h, lq, 64).bfloat16()
    aligned_fp32 = torch.randn(h, lq, 4)
    for bias in (padded, aligned_bf16, aligned_fp32, padded[:, :, :60]):
        assert tfa.tma_rows(bias) and tfa.row_padded(bias) is bias
    odd = torch.randn(h, lq, 65).bfloat16()
    shifted = torch.randn(h * lq * 64 + 1).bfloat16()[1:].view(h, lq, 64)
    for bias in (odd, shifted, torch.randn(h, lq, 6)):
        assert not tfa.tma_rows(bias)
        copy = tfa.row_padded(bias)
        assert copy is not bias and tfa.tma_rows(copy) and torch.equal(copy, bias)


@pytest.mark.parametrize("fca", [False, True], ids=["causal", "full-context"])
def test_training_packs_have_16_byte_rows(monkeypatch, fca):
    """The image-free training forward hands every attention call a bias
    whose rows start at multiples of 16 bytes, at a grid and src_len where
    the encoder length (16 + 10) and the decoder length (1 + 16) are not
    multiples of 8; the tables still get their gradient through the padding."""
    seen = []

    def spy(q, k, v, bias, *rest):
        seen.append(bias)
        return tfa.flash_attention_bias_packed_stats(q, k, v, bias, *rest)

    monkeypatch.setattr(tattention, "flash_attention_bias_packed_stats", spy)
    model = torch_tiny(seed=3).train()
    tokens, lengths = class_table(5)
    batch = train_batch(seed=4)
    t = lambda x: torch.from_numpy(np.asarray(x)).long()
    _, extra = model(aux_grid_ids=t(batch["aux_grid_ids"]), aux_src_tokens=t(batch["src_tokens"]),
                     bos_tokens=t(batch["bos_tokens"]), class_tokens=t(tokens),
                     class_lengths=t(lengths), full_context_alignment=fca)
    extra["aux_output"].float().square().mean().backward()
    shapes = {tuple(bias.shape[1:]) for bias in seen}
    assert shapes == {(26, 26), (17, 17), (17, 26)}  # encoder self, decoder self, cross
    for bias in seen:
        assert bias.stride(-1) == 1 and bias.stride(-2) % 8 == 0
        assert bias.data_ptr() % 16 == 0 and tfa.tma_rows(bias)
    unaligned = [bias for bias in seen if bias.shape[-1] % 8]
    assert unaligned and all(bias.stride(-2) > bias.shape[-1] for bias in unaligned)
    for name in ("encoder.token_rel_pos_table_list.0.weight",
                 "encoder.image_rel_pos_table_list.1.weight",
                 "decoder.seg_rel_pos_table_list.0.weight"):
        grad = dict(model.named_parameters())[name].grad
        assert grad is not None and torch.isfinite(grad).all() and grad.abs().sum() > 0
