"""The port's plain stats forward and plain explicit backward against the
JAX package's Pallas forward-with-stats and backward kernels.

``attention_bias_stats_reference`` and ``attention_bias_backward_reference``
are what the port's autograd Function runs on CPU tensors and what the
Hopper kernels are held against on the card; here they are held against
``flash_attention_bias_packed_stats`` and ``_flash_backward`` of the JAX
package, run in Pallas interpret mode on the CPU, in fp32.

Tolerance 2e-4 (atol and rtol), the bound the JAX package's own backward
tests use: both sides accumulate in fp32 and differ in summation order.  The
bf16-bias case rounds dbias to bf16 on both sides, so it gets one bf16 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ifseg_tpu.ops.flash_attention as jfa
from ifseg_torch.ops import flash_attention as tfa
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

TOL = 2e-4


@pytest.fixture(autouse=True)
def force_interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _inputs(b, h, lq, lk, d, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h * d)).astype(np.float32) * 0.3
    k = rng.normal(size=(b, lk, h * d)).astype(np.float32) * 0.3
    v = rng.normal(size=(b, lk, h * d)).astype(np.float32)
    bias = rng.normal(size=(h, lq, lk)).astype(np.float32)
    g = rng.normal(size=(b, lq, h * d)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((b, lk), bool)
        mask[-1, lk - 5:] = True
    return q, k, v, bias, g, mask


def _jax_lse_to_bhl(lse, b, h, lq):
    """JAX lse layout (B, H/hb, Lq, hb) -> the port's (B, H, Lq)."""
    return np.asarray(lse).transpose(0, 1, 3, 2).reshape(b, h, lq)


CASES = {
    "full": dict(lq=64, lk=64, causal=False, with_mask=False),
    "causal": dict(lq=64, lk=64, causal=True, with_mask=False),
    "mask": dict(lq=64, lk=72, causal=False, with_mask=True),
    "causal-mask-ragged": dict(lq=40, lk=72, causal=True, with_mask=True),
    "ragged-lq": dict(lq=33, lk=33, causal=True, with_mask=False),
    "bf16-bias": dict(lq=40, lk=72, causal=False, with_mask=True, bias_dtype="bf16"),
    "no-bias": dict(lq=48, lk=48, causal=False, with_mask=False, bias_dtype=None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_stats_and_backward_match_pallas(case):
    spec = dict(CASES[case])
    bias_dtype = spec.pop("bias_dtype", "fp32")
    lq, lk, causal, with_mask = spec["lq"], spec["lk"], spec["causal"], spec["with_mask"]
    b, h, d = 2, 2, 64
    q, k, v, bias, g, mask = _inputs(b, h, lq, lk, d, with_mask)

    jbias = {None: None, "fp32": jnp.asarray(bias), "bf16": jnp.asarray(bias, jnp.bfloat16)}[bias_dtype]
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
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, lq)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse_to_bhl(jlse, b, h, lq), atol=TOL, rtol=TOL)

    dq, dk, dv, db = tfa.attention_bias_backward_reference(
        tq, tk, tv, tbias, tmask, causal, tg, out, lse, h)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=TOL, rtol=TOL)
    if bias_dtype is None:
        assert db is None and jdb is None
    else:
        assert db.dtype == tbias.dtype
        tol = TOL if bias_dtype == "fp32" else 2 ** -7  # one bf16 ulp, relative
        np.testing.assert_allclose(db.float().numpy(), np.asarray(jdb.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,with_mask,with_bias",
                         [(False, False, True), (True, True, True), (False, True, False)],
                         ids=["full", "causal-mask", "no-bias"])
def test_function_backward_agrees_with_autograd_of_plain_forward(causal, with_mask, with_bias):
    """The Function's explicit backward (the wiring the card uses) against
    autograd through the plain forward: 2e-5 (both compute in fp32)."""
    b, h, lq, lk, d = 2, 2, 24, 40, 8
    q, k, v, bias, g, mask = _inputs(b, h, lq, lk, d, with_mask, seed=5)
    tmask = None if mask is None else torch.from_numpy(mask)

    def leaves():
        out = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out.append(torch.from_numpy(bias).requires_grad_(True) if with_bias else None)
        return out

    a = leaves()
    out_a, lse_a = tfa.flash_attention_bias_packed_stats(*a, tmask, causal, h)
    assert not lse_a.requires_grad  # stats only: no gradient flows through lse
    out_a.backward(torch.from_numpy(g))
    r = leaves()
    tfa.attention_bias_reference(*r, tmask, causal, h).backward(torch.from_numpy(g))
    for got, want in zip(a, r):
        if got is None:
            continue
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), atol=2e-5, rtol=2e-5)


def test_packed_is_the_stats_output_and_cpu_counts_no_launch():
    q, k, v, bias, g, mask = _inputs(2, 2, 24, 40, 64, True, seed=1)
    args = [torch.from_numpy(x) for x in (q, k, v, bias)] + [torch.from_numpy(mask)]
    before = tfa.launch_counts()
    out = tfa.flash_attention_bias_packed(*args, True, 2)
    out2, _ = tfa.flash_attention_bias_packed_stats(*args, True, 2)
    assert tfa.launch_counts() == before
    assert torch.equal(out, out2)
    assert torch.equal(out, tfa.attention_bias_stats_reference(*args, True, 2)[0])


def test_bias_without_grad_gets_no_dbias():
    q, k, v, bias, g, mask = _inputs(1, 2, 16, 16, 8, False, seed=2)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tb = torch.from_numpy(bias)  # requires no grad
    tfa.flash_attention_bias_packed(tq, tk, tv, tb, None, False, 2).sum().backward()
    assert tb.grad is None and tq.grad is not None


@pytest.mark.parametrize(
    "case,match",
    [("g_dtype", "g must be"), ("lse_shape", "lse must be"), ("out_shape", "out must be")],
)
def test_backward_checks_refuse_what_the_kernels_do_not_take(case, match):
    b, h, lq = 2, 2, 16
    q = torch.zeros(b, lq, h * 64, dtype=torch.bfloat16)
    g, out = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros(b, h, lq)
    if case == "g_dtype":
        g = g.float()
    elif case == "lse_shape":
        lse = torch.zeros(b, lq, h)
    elif case == "out_shape":
        out = out[:, :-1]
    with pytest.raises(ValueError, match=match):
        tfa._check_backward(q, g, out, lse, h)
    tfa._check_backward(q, torch.zeros_like(q), torch.zeros_like(q), torch.zeros(b, h, lq), h)
