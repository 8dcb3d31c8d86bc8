"""The port's ``gelu_poly`` (``ifseg_torch/ops/gelu.py``) against the JAX
package's over every finite bf16 input, in one vectorised pass each: the
bf16 outputs at most 1 bf16 ulp apart (the fp32 ``exp`` of the two
libraries may differ in its last bit), and the count of inputs that differ
printed, wherever the input and both outputs are normal fp32 numbers (XLA
on the CPU flushes subnormals to zero and PyTorch keeps them: elsewhere both
outputs must be within 4 · tiny of zero); the JAX test's float64 check (never worse than the fp32 1+erf
formula, modulo 1 ulp) run on the port's outputs; the edge cases; and the
model's FFN with ``activation_fn="gelu_poly"`` against the JAX layer.
"""

import math

import jax.numpy as jnp
import numpy as np
import torch

from ifseg_torch.ops.gelu import gelu_poly as t_gelu
from ifseg_tpu.ops.gelu import gelu_poly as j_gelu
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


def _all_finite_bf16_as_f32():
    bits = np.arange(65536, dtype=np.uint32) << 16
    f32 = bits.view(np.float32)
    return f32[np.isfinite(f32)]


def _key(a):
    """bf16 bit patterns of fp32 values (round to nearest even), remapped to
    a sign-monotone integer so a difference of keys counts ulps, across ±0."""
    b = np.asarray(a, np.float32).view(np.uint32)
    bits = (((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000) >> 16).astype(np.int64)
    return np.where((bits & 0x8000) != 0, 0x8000 - (bits & 0x7FFF), 0x8000 + bits)


def test_all_bf16_inputs_within_one_ulp_of_jax():
    x = _all_finite_bf16_as_f32()
    assert x.size == 65280
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(j_gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = t_gelu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    normal = (np.abs(x) >= tiny) & (np.abs(got) >= 2 * tiny) & (np.abs(want) >= 2 * tiny)
    ulps = np.abs(_key(got) - _key(want))
    print(f"gelu_poly: {int((ulps[normal] > 0).sum())} of {int(normal.sum())} bf16 inputs with "
          f"a normal input and outputs differ from JAX (at most {int(ulps[normal].max())} ulp); "
          f"of the other {int((~normal).sum())}, {int((ulps[~normal] > 0).sum())} differ "
          "(subnormals)")
    assert ulps[normal].max() <= 1
    assert np.all((ulps[~normal] == 0)
                  | ((np.abs(got[~normal]) <= 4 * tiny) & (np.abs(want[~normal]) <= 4 * tiny)))


def test_never_worse_than_the_f32_erf_formula():
    """The JAX test's float64 check, on the port's outputs."""
    x32 = _all_finite_bf16_as_f32()
    x64 = x32.astype(np.float64)
    ref = 0.5 * x64 * np.vectorize(math.erfc)(-x64 / math.sqrt(2))
    cur = (np.float32(0.5) * x32
           * (np.float32(1.0) + np.vectorize(math.erf)(x64 / math.sqrt(2)).astype(np.float32)))
    poly = t_gelu(torch.from_numpy(x32)).numpy()
    d_poly = np.abs(_key(poly) - _key(ref))
    d_cur = np.abs(_key(cur) - _key(ref))
    normal = (np.abs(ref) >= 2 * np.finfo(np.float32).tiny) | (ref == 0.0)
    assert np.all(d_poly[normal] <= d_cur[normal] + 1)
    assert np.all(np.abs(poly[~normal]) <= 4 * np.finfo(np.float32).tiny)


def test_gradient_matches_jax_grad():
    """The backward (the formula run again under autograd from the saved
    input) against ``jax.grad`` of the JAX function, fp32, over the
    branches and their seams."""
    import jax

    x = np.linspace(-9.0, 4.0, 4001, dtype=np.float32)
    want = np.asarray(jax.vmap(jax.grad(lambda v: j_gelu(v)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_gelu(xt)
    y.backward(torch.ones_like(y))
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(y.detach().numpy(), t_gelu(torch.from_numpy(x)).numpy())


def test_edge_cases():
    x = torch.tensor([np.inf, -np.inf, np.nan, 0.0, -0.0, 100.0, -100.0])
    y = t_gelu(x).numpy()
    assert y[0] == np.inf and y[1] == 0.0 and np.signbit(y[1]) and np.isnan(y[2])
    assert y[3] == 0.0 and y[4] == 0.0 and y[5] == 100.0 and y[6] == 0.0
    assert t_gelu(x.to(torch.bfloat16)).dtype == torch.bfloat16


def test_ffn_with_gelu_poly_matches_jax():
    import jax

    from ifseg_torch.models.layers import FeedForward
    from ifseg_tpu.models.layers import FeedForward as JaxFeedForward

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 2
    jmod = JaxFeedForward(16, 32, activation_fn="gelu_poly")
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = FeedForward(16, 32, activation_fn="gelu_poly")
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(tmod, name).weight.copy_(torch.from_numpy(np.array(params[name]["kernel"]).T))
            getattr(tmod, name).bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
        tmod.ffn_layernorm.weight.copy_(torch.from_numpy(np.array(params["ffn_layernorm"]["scale"])))
        tmod.ffn_layernorm.bias.copy_(torch.from_numpy(np.array(params["ffn_layernorm"]["bias"])))
        got = tmod.eval().ffn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
