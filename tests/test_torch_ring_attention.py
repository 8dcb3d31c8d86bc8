"""The port's ring attention (``ifseg_torch.parallel.context.ring_attention``)
against the JAX package's ``ring_attention`` on the virtual CPU mesh.

Four gloo ranks are spawned once for the file: a ring of all four, and
the pairs {0, 1} and {2, 3} as rings of two.  Inputs are numpy-seeded
(B, H, L, D) fp32 tensors, laid out packed (B, L, H·D) for the port.
Against the JAX function on a (1, 1, n) mesh: the output within 1e-5
relative, and the gradients of sum(out²) with respect to q, k, v and the
bias within 1e-4 relative, with a bias and without, at a length that
divides the ring and at odd lengths (padded), causal with a key padding
mask.
"""

import numpy as np
import pytest

from torch_parallel_utils import spawn
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

CASES = {  # name: (ring, b, h, l, d, bias, masked, causal, seed)
    "bias": (4, 2, 3, 32, 8, True, False, False, 0),
    "no-bias": (4, 1, 2, 16, 4, False, False, False, 1),
    "odd-causal-masked-bias": (4, 2, 2, 33, 8, True, True, True, 2),
    "odd-no-mask": (2, 1, 2, 13, 4, False, False, False, 3),
    "ring2-causal-bias": (2, 2, 3, 17, 8, True, False, True, 4),
}


def _inputs(b, h, l, d, bias, masked, seed):
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=(b, h, l, d)).astype(np.float32) for k in "qkv"}
    out["bias"] = rng.normal(size=(h, l, l)).astype(np.float32) if bias else None
    mask = None
    if masked:
        mask = rng.random(size=(b, l)) < 0.2
        mask[:, 0] = False  # one visible key a row
    out["mask"] = mask
    return out


def _port(group, n, b, h, l, d, bias, masked, causal, seed):
    import torch

    from ifseg_torch.parallel.context import ring_attention

    a = _inputs(b, h, l, d, bias, masked, seed)
    packed = {k: torch.tensor(a[k].transpose(0, 2, 1, 3).reshape(b, l, h * d),
                              requires_grad=True) for k in "qkv"}
    tb = None if a["bias"] is None else torch.tensor(a["bias"], requires_grad=True)
    mask = None if a["mask"] is None else torch.tensor(a["mask"])
    out = ring_attention(packed["q"], packed["k"], packed["v"], tb, mask, causal, h, group)
    (out ** 2).sum().backward()
    unpack = lambda t: t.detach().reshape(b, l, h, d).permute(0, 2, 1, 3).numpy()
    res = dict(out=unpack(out), **{f"g_{k}": unpack(packed[k].grad) for k in "qkv"})
    if tb is not None:
        res["g_bias"] = tb.grad.numpy()
    return res


def _worker(rank, world):
    import torch.distributed as dist

    pair = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
    return {name: _port(dist.group.WORLD if c[0] == 4 else pair, *c)
            for name, c in CASES.items()}


def _jax(n, b, h, l, d, bias, masked, causal, seed):
    import jax
    import jax.numpy as jnp

    from ifseg_tpu.parallel.context import ring_attention
    from ifseg_tpu.parallel.mesh import MeshConfig, build_mesh

    a = _inputs(b, h, l, d, bias, masked, seed)
    mesh = build_mesh(MeshConfig(data_parallel=1, tensor_parallel=n), jax.devices()[:n])
    mask = None if a["mask"] is None else jnp.asarray(a["mask"])

    def loss(q, k, v, bb):
        out = ring_attention(q, k, v, bb, mesh, key_padding_mask=mask, causal=causal)
        return jnp.sum(out ** 2), out

    args = [jnp.asarray(a[k]) for k in "qkv"] + [
        None if a["bias"] is None else jnp.asarray(a["bias"])]
    argnums = (0, 1, 2, 3) if bias else (0, 1, 2)
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=argnums, has_aux=True))(*args)
    res = dict(out=np.asarray(out), **{f"g_{k}": np.asarray(g) for k, g in zip("qkv", grads)})
    if bias:
        res["g_bias"] = np.asarray(grads[3])
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(4, _worker, (), tmp_path_factory.mktemp("ring"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_attention_matches_jax(port, name):
    want = _jax(*CASES[name])
    for rank in range(4):  # every rank of the ring holds the whole output and gradients
        got = port[rank][name]
        assert set(got) == set(want)
        for k, v in want.items():
            err = np.linalg.norm(got[k] - v) / max(np.linalg.norm(v), 1e-30)
            assert err <= (1e-5 if k == "out" else 1e-4), (k, err)
