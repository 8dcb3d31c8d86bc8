"""The port's ``LightConv`` and ``DynamicConv`` (``models/lightconv.py``)
against the JAX package's flax modules on converted parameters
(``lightconv_state_from_jax``), CPU, fp32: the output within 1e-5 (absolute
and relative), and the gradients of a seeded cotangent with respect to the
input and to the parameters within 1e-5 of ``jax.grad``'s; causal and not,
odd and even kernels (the even one pads unequally).  Weight dropout draws
from the module's generator in training mode and is the identity in eval
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import lightconv_state_from_jax
from ifseg_torch.models import lightconv as tl
from ifseg_torch.models.attention import set_generator
from ifseg_tpu.models import lightconv as jl
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

TOL = 1e-5
CASES = [(3, 4, False), (3, 4, True), (4, 2, False), (4, 2, True), (7, 8, False)]


def _pair(kind, k, h, causal, c, seed):
    x = np.random.default_rng(seed).normal(size=(2, 11, c)).astype(np.float32)
    if kind == "light":
        jm = jl.LightConv(kernel_size=k, num_heads=h, causal=causal)
        tm = tl.LightConv(kernel_size=k, num_heads=h, causal=causal)
    else:
        jm = jl.DynamicConv(kernel_size=k, num_heads=h, causal=causal)
        tm = tl.DynamicConv(c, kernel_size=k, num_heads=h, causal=causal)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    if kind == "light":  # past the near-uniform init, so the softmax matters
        params = {"weight": params["weight"] * 20.0}
    tm.load_state_dict(lightconv_state_from_jax(jax.device_get(params)), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("kind", ["light", "dynamic"])
@pytest.mark.parametrize("k,h,causal", CASES)
def test_forward_and_gradients_match_jax(kind, k, h, causal):
    c = 16
    jm, params, tm, x = _pair(kind, k, h, causal, c, seed=k * 10 + h)
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * cot)

    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    want_p = lightconv_state_from_jax(jax.device_get(gp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_p[name].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
    # a causal output at position t reads no input after t
    if causal:
        xt2 = xt.detach().clone()
        xt2[:, 5:] += 1.0
        assert torch.equal(tm(xt2)[:, :5], got[:, :5].detach())


@pytest.mark.parametrize("kind", ["light", "dynamic"])
def test_weight_dropout_draws_from_the_generator(kind):
    c = 16
    m = (tl.LightConv(3, 4, weight_dropout=0.5) if kind == "light"
         else tl.DynamicConv(c, 3, 4, weight_dropout=0.5)).init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 9, c, generator=torch.Generator().manual_seed(1))
    m.eval()
    plain = m(x)
    m.train()
    outs = []
    for _ in range(2):
        set_generator(m, torch.Generator().manual_seed(5))
        outs.append(m(x))
    assert torch.equal(outs[0], outs[1]) and not torch.allclose(outs[0], plain)
    m.weight_dropout.rate = 0.0
    assert torch.equal(m(x), plain)


def test_shapes_and_init():
    g = torch.Generator().manual_seed(0)
    light = tl.LightConv().init(g)
    assert tuple(light.weight.shape) == (4, 3) and light.kernel_size == 3
    assert abs(float(light.weight.detach().std()) - 0.1) < 0.1
    dyn = tl.DynamicConv(768, kernel_size=31, num_heads=16).init(g)
    w = dyn.weight_linear.weight.detach()
    assert tuple(w.shape) == (16 * 31, 768) and dyn.weight_linear.bias is None
    std = 768 ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) * 768 ** 0.5 - 1.0) < 0.05
    with pytest.raises(ValueError, match="heads"):
        light(torch.zeros(1, 4, 6))
