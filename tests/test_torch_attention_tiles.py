"""The port's plain attention at the edges of the Hopper forward kernel's tiles.

The kernel works on 128-row query tiles and 128-key stages, with one consumer
warpgroup per 64 rows, and stages the bias by TMA or by threads depending on
the alignment of its rows.  Its plain versions are what it is held against on
the card, so here they are held against the JAX package's Pallas kernel (run
in interpret mode on the CPU) at the shapes where those tiles end: lengths of
1, 65, 129 and 257, causal with more keys than queries, a key tile that is
padded as a whole, a mask together with causal.

Tolerances as in ``test_torch_attention.py``: fp32 inputs 2e-5 (both sides
accumulate in fp32 and differ only in summation order), the row logsumexp
2e-5; bf16 inputs 2e-2 (both round the probabilities to bf16 before the P·V
product, at different points of their sums).

A bias may also come as a view of row-padded storage (``row_padded``): the
CPU route must give the same answer for the view as for the dense bias, and
the checks that run before every launch must take it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ifseg_tpu.ops.flash_attention as jfa
from ifseg_torch.ops import flash_attention as tfa


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
    mask = None
    if mask_kind is not None:
        mask = np.zeros((b, lk), bool)
        mask[-1, max(lk - 5, 1):] = True  # key 0 stays visible: no fully masked row
        if mask_kind == "tile":  # the kernel's second key tile, padded as a whole
            mask[:, 128:256] = True
    return q, k, v, bias, mask


def _jax_lse_to_bhl(lse, b, h, lq):
    """JAX lse layout (B, H/hb, Lq, hb) -> the port's (B, H, Lq)."""
    return np.asarray(lse).transpose(0, 1, 3, 2).reshape(b, h, lq)


DTYPES = {
    "fp32": (torch.float32, jnp.float32, 2e-5),
    "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2),
}

# (Lq, Lk, causal, key mask)
EDGES = {
    "1x1-causal": (1, 1, True, None),
    "1x65-mask": (1, 65, False, "tail"),
    "65x129-causal-mask": (65, 129, True, "tail"),
    "129x65": (129, 65, False, None),
    "129x257-causal-padded-tile": (129, 257, True, "tile"),
    "257x257-causal-padded-tile": (257, 257, True, "tile"),
    "257x129-mask": (257, 129, False, "tail"),
    "65x257-padded-tile": (65, 257, False, "tile"),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("edge", list(EDGES))
def test_plain_forward_matches_pallas_at_tile_edges(edge, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    lq, lk, causal, mask_kind = EDGES[edge]
    b, h, d = 2, 2, 64
    q, k, v, bias, mask = _inputs(b, h, lq, lk, d, mask_kind, seed=lq * 1000 + lk)
    want = jfa.flash_attention_bias_packed_infer(
        *(jnp.asarray(x, jdt) for x in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), causal, h)
    got = tfa.flash_attention_bias_packed_infer(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask), causal, h)
    assert got.dtype == tdt and tuple(got.shape) == (b, lq, h * d)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("edge", list(EDGES))
def test_plain_forward_with_stats_matches_pallas_at_tile_edges(edge, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    lq, lk, causal, mask_kind = EDGES[edge]
    b, h, d = 2, 2, 64
    q, k, v, bias, mask = _inputs(b, h, lq, lk, d, mask_kind, seed=lq * 1000 + lk + 1)
    jout, jlse = jfa.flash_attention_bias_packed_stats(
        *(jnp.asarray(x, jdt) for x in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), causal, h)
    out, lse = tfa.flash_attention_bias_packed_stats(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask), causal, h)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, lq)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    # the lse sums fp32 logits of the same inputs on both sides
    np.testing.assert_allclose(lse.numpy(), _jax_lse_to_bhl(jlse, b, h, lq),
                               atol=max(tol, 2e-5) if dtype == "fp32" else 2e-2, rtol=tol)


def test_plain_forward_matches_the_jax_reference_without_a_bias():
    """No bias, one query row against 257 keys: against ``_attention_xla``,
    the JAX package's plain reference (legacy layout)."""
    b, h, lq, lk, d = 1, 2, 1, 257, 64
    q, k, v, _, mask = _inputs(b, h, lq, lk, d, "tile", seed=5)
    heads = lambda x: jnp.asarray(x).reshape(x.shape[0], x.shape[1], h, d).transpose(0, 2, 1, 3)
    want = jfa._attention_xla(heads(q), heads(k), heads(v), None, jnp.asarray(mask), False)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b, lq, h * d)
    got = tfa.attention_bias_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), None, torch.from_numpy(mask), False, h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------ row-padded bias

@pytest.mark.parametrize("lk,pitch", [(65, 72), (129, 136), (64, 64), (1, 8)])
def test_row_padded_keeps_values_and_aligns_rows(lk, pitch):
    rng = np.random.default_rng(lk)
    bias = torch.from_numpy(rng.normal(size=(3, 2, 5, lk)).astype(np.float32)).bfloat16()
    view = tfa.row_padded(bias)
    assert view.shape == bias.shape and torch.equal(view, bias)
    assert view.stride(-1) == 1 and view.stride(-2) == pitch and pitch % 8 == 0
    assert view.stride(-3) == 5 * pitch
    for layer in view:  # what a model hands to one attention call
        assert layer.data_ptr() % 16 == 0 or pitch == lk
        assert layer.is_contiguous() or tfa._is_row_padded(layer)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_cpu_route_gives_the_same_for_a_row_padded_bias(causal):
    b, h, lq, lk, d = 2, 2, 33, 65, 64
    q, k, v, bias, mask = _inputs(b, h, lq, lk, d, "tail", seed=9)
    tq, tk, tv, tbias = (torch.from_numpy(x) for x in (q, k, v, bias))
    tmask = torch.from_numpy(mask)
    view = tfa.row_padded(tbias)
    assert not view.is_contiguous()
    tfa._check(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), view.bfloat16(), tmask, causal, h)
    want = tfa.flash_attention_bias_packed_infer(tq, tk, tv, tbias, tmask, causal, h)
    got = tfa.flash_attention_bias_packed_infer(tq, tk, tv, view, tmask, causal, h)
    assert torch.equal(got, want)

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    dense, padded = tbias.clone().requires_grad_(True), view.detach().requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=q.shape).astype(np.float32))
    grads = []
    for bias_leaf in (dense, padded):
        out, lse = tfa.flash_attention_bias_packed_stats(*leaves, bias_leaf, tmask, causal, h)
        grads.append(torch.autograd.grad(out, leaves + [bias_leaf], g))
    for a, b_ in zip(*grads):
        assert a.shape == b_.shape and torch.equal(a, b_)


def test_a_bias_view_that_is_not_row_padded_is_told_apart():
    h, lq, lk = 2, 6, 10
    storage = torch.zeros(h, lq, 16, dtype=torch.bfloat16)
    assert tfa._is_row_padded(storage[..., :lk])
    assert not tfa._is_row_padded(storage[..., 2:2 + lk:2][..., :5])  # strided keys
    assert not tfa._is_row_padded(storage[:, :4, :lk])                # rows left out of a head
    assert not tfa._is_row_padded(torch.zeros(h, lk, lq, dtype=torch.bfloat16).transpose(1, 2))
    short = torch.zeros(h * lq * 16 - 4, dtype=torch.bfloat16).as_strided((h, lq, lk), (lq * 16, 16, 1))
    assert tfa._is_row_padded(short)  # the last row's padding need not exist: it is never read
