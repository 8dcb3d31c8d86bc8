"""The port's one-pass LayerNorm against the JAX package's ``fused_layer_norm``.

On the CPU the port takes the plain version (``layer_norm_reference``), which
is what the CUDA kernel is held against on the card.  It is compared with
the JAX op through its math route and through the Pallas kernel in interpret
mode (forced by monkeypatching inside the test, as ``tests/test_layer_norm.py``
does).  Tolerances: fp32 output 1e-5 (both sides fp32, other summation
order); bf16 output one bf16 ulp (4e-3 relative: both round the same fp32
value once, but that value differs in its last bits); gradients rtol 2e-4 /
atol 2e-3, the bound the JAX test holds its own backward to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ifseg_torch.models.layers import LayerNorm as TorchLayerNorm
from ifseg_torch.ops import layer_norm as tln
from ifseg_tpu.ops import layer_norm as jln
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

EPS = 1e-5


def _data(seed=0, shape=(4, 24, 256)):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    scale = (rng.normal(size=(d,)) * 0.2 + 1).astype(np.float32)
    bias = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    return x, scale, bias


def _force_pallas(monkeypatch):
    monkeypatch.setattr(jln, "_use_pallas", lambda n, d: True)
    orig = jln.pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jln.pl, "pallas_call", interp_call)


def _jax_ln(x, scale, bias, in_dtype, out_dtype):
    return np.asarray(
        jln.fused_layer_norm(jnp.asarray(x, in_dtype), jnp.asarray(scale), jnp.asarray(bias),
                             EPS, jnp.dtype(out_dtype)).astype(jnp.float32))


def _torch_ln(fn, x, scale, bias, in_dtype, out_dtype):
    y = fn(torch.from_numpy(x).to(in_dtype), torch.from_numpy(scale), torch.from_numpy(bias),
           EPS, out_dtype)
    assert y.dtype == out_dtype
    return y.float().numpy()


@pytest.mark.parametrize("route", ["math", "pallas-interpret"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_reference_matches_jax_fp32_out(monkeypatch, route, in_dtype):
    if route == "pallas-interpret":
        _force_pallas(monkeypatch)
    x, scale, bias = _data()
    want = _jax_ln(x, scale, bias, getattr(jnp, in_dtype), jnp.float32)
    for fn in (tln.layer_norm_reference, tln.fused_layer_norm):
        got = _torch_ln(fn, x, scale, bias, getattr(torch, in_dtype), torch.float32)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("route", ["math", "pallas-interpret"])
def test_reference_matches_jax_bf16_out(monkeypatch, route):
    if route == "pallas-interpret":
        _force_pallas(monkeypatch)
    x, scale, bias = _data(1)
    want = _jax_ln(x, scale, bias, jnp.bfloat16, jnp.bfloat16)
    got = _torch_ln(tln.fused_layer_norm, x, scale, bias, torch.bfloat16, torch.bfloat16)
    # one bf16 ulp: 2^-8 relative to the value's binade
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    assert (got == want).mean() > 0.99


def test_gradients_match_jax_grad():
    x, scale, bias = _data(2)
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def loss(x_, s_, b_):
        return jnp.sum(jln.fused_layer_norm(x_, s_, b_, EPS, jnp.dtype(jnp.float32)) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    (tln.fused_layer_norm(*leaves, EPS, torch.float32) * torch.from_numpy(w)).sum().backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-3)


def test_backward_of_bf16_input_is_bf16():
    x, scale, bias = _data(4, shape=(6, 64))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    st, bt = (torch.from_numpy(a).requires_grad_(True) for a in (scale, bias))
    tln.fused_layer_norm(xt, st, bt, EPS, torch.bfloat16).float().sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    assert st.grad.dtype == bt.grad.dtype == torch.float32
    # d/dbias of a plain sum is the row count
    np.testing.assert_allclose(bt.grad.numpy(), 6.0)


@pytest.mark.parametrize("width", [100, 4, 16392])  # not a multiple of 8, too narrow, too wide
def test_check_refuses_unsupported_width(width):
    x = torch.zeros(3, width)
    with pytest.raises(ValueError, match="width"):
        tln._check(x, torch.ones(width), torch.zeros(width), torch.float32)


@pytest.mark.parametrize("case", ["half-in", "int-out", "fp64-scale", "short-bias", "strided"])
def test_check_refuses_other_operands(case):
    x, s, b, out = torch.zeros(3, 64), torch.ones(64), torch.zeros(64), torch.float32
    if case == "half-in":
        x = x.half()
    elif case == "int-out":
        out = torch.int32
    elif case == "fp64-scale":
        s = s.double()
    elif case == "short-bias":
        b = b[:32]
    else:
        x = torch.zeros(3, 128)[:, ::2]
    with pytest.raises(ValueError):
        tln._check(x, s, b, out)


def test_check_accepts_every_multiple_of_8():
    for width in (8, 32, 768, 3072, 4096, 4104, 5120, 16384):
        tln._check(torch.zeros(2, width), torch.ones(width), torch.zeros(width), torch.bfloat16)


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="device"):
        tln.fused_layer_norm(torch.zeros(2, 8, device="meta"), torch.ones(8, device="meta"),
                             torch.zeros(8, device="meta"))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_module_out_dtype_and_routes(out_dtype):
    """Without a gradient the module is the fused op (fast variance); with
    one it is ``F.layer_norm`` and a cast; both return ``out_dtype`` and agree
    to fp32 rounding."""
    x, scale, bias = _data(5, shape=(3, 7, 32))
    m = TorchLayerNorm(32)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x)
    before = tln.LAUNCHES
    with torch.no_grad():
        fused = m(xt, out_dtype)
    graded = m(xt, out_dtype)
    assert tln.LAUNCHES == before  # CPU tensors never count as kernel launches
    assert fused.dtype == graded.dtype == out_dtype
    assert not fused.requires_grad and graded.requires_grad
    assert m(xt).dtype == torch.float32
    want = tln.layer_norm_reference(xt, m.weight.detach(), m.bias.detach(), EPS, out_dtype)
    assert torch.equal(fused, want)
    tol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(graded.detach().float().numpy(), want.float().numpy(),
                               atol=1e-5, rtol=tol)
