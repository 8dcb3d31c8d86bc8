"""The port's GPipe schedule (``ifseg_torch.parallel.pipeline.gpipe``)
against the JAX package's ``gpipe`` on the virtual CPU mesh.

Four gloo ranks are spawned once for the file: ranks {0, 1} and {2, 3} form
two 2-stage pipelines, all four a 4-stage one.  A stage is one linear and a
tanh on its slice of the stacked (S, d, d) weights and (S, d) biases; the
inputs are numpy-seeded.  Against the JAX function on a (1, 1, S) mesh:
the output within 1e-5 relative and the gradients of sum(out²) with
respect to the weights, biases and input within 1e-4 relative, at 2 and 4
stages; a two-tensor carry (fp32 and bf16) with a per-row constant every
stage reads (``mb_consts``, its gradient too); a non-float carry raising;
and the microbatch count clamped to gcd(M, rows) with the JAX warning.
"""

import logging

import numpy as np
import pytest

from torch_parallel_utils import spawn
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

D = 6


def _inputs(s, rows, seed):
    rng = np.random.default_rng(seed)
    return dict(w=(rng.normal(size=(s, D, D)) * 0.5).astype(np.float32),
                b=(rng.normal(size=(s, D)) * 0.1).astype(np.float32),
                x=rng.normal(size=(rows, D)).astype(np.float32),
                y=rng.normal(size=(rows, D)).astype(np.float32),
                c=rng.normal(size=(rows, D)).astype(np.float32))


CASES = {  # name: (stages, rows, chunks, seed)
    "s2": (2, 8, 4, 0),
    "s4": (4, 24, 6, 1),
    "s2-clamped": (2, 6, 4, 2),
}
MULTI = (4, 20, 5, 3)


def _port_linear(group, s, rows, chunks, seed):
    import torch

    from ifseg_torch.parallel.pipeline import gpipe

    t = {k: torch.tensor(v, requires_grad=True) for k, v in _inputs(s, rows, seed).items()}

    def stage_fn(carry, row, consts, bcast, mb):
        return [torch.tanh(carry[0] @ consts[0] + consts[1])]

    out = gpipe(stage_fn, [t["x"]], group, chunks=chunks, stage_consts=[t["w"], t["b"]])[0]
    (out ** 2).sum().backward()
    return dict(out=out.detach().numpy(), **{f"g_{k}": t[k].grad.numpy() for k in "wbx"})


def _port_multi(group, s, rows, chunks, seed):
    import torch

    from ifseg_torch.parallel.pipeline import gpipe

    t = {k: torch.tensor(v) for k, v in _inputs(s, rows, seed).items()}
    x = t["x"].requires_grad_()
    c = t["c"].requires_grad_()
    y = t["y"].to(torch.bfloat16)

    def stage_fn(carry, row, consts, bcast, mb):
        xx, yy = carry
        xx = torch.tanh(xx @ consts[0] + row[0])
        return [xx, (yy.float() + xx).to(torch.bfloat16)]

    ox, oy = gpipe(stage_fn, [x, y], group, chunks=chunks, mb_consts=[c], stage_consts=[t["w"]])
    (ox ** 2).sum().backward()
    return dict(out_x=ox.detach().numpy(), out_y=oy.detach().float().numpy(), g_x=x.grad.numpy(),
                g_c=c.grad.numpy())


def _worker(rank, world):
    import torch.distributed as dist

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    out = {name: _port_linear(dist.group.WORLD if s == 4 else pair, s, rows, chunks, seed)
           for name, (s, rows, chunks, seed) in CASES.items()}
    out["multi"] = _port_multi(dist.group.WORLD, *MULTI)
    return out


def _jax(name):
    import jax
    import jax.numpy as jnp

    from ifseg_tpu.parallel.mesh import MeshConfig, build_mesh
    from ifseg_tpu.parallel.pipeline import gpipe

    if name == "multi":
        s, rows, chunks, seed = MULTI
        a = _inputs(s, rows, seed)
        mesh = build_mesh(MeshConfig(data_parallel=1, tensor_parallel=s), jax.devices()[:s])

        def stage_fn(w, consts, bcast, carry, mbrow, mb):
            x, y = carry
            x = jnp.tanh(x @ w + mbrow["c"])
            return (x, (y.astype(jnp.float32) + x).astype(jnp.bfloat16))

        def run(x, c):
            return gpipe(jnp.asarray(a["w"]), stage_fn, (x, jnp.asarray(a["y"], jnp.bfloat16)),
                         mesh, mb_consts={"c": c}, chunks=chunks)

        (ox, oy), vjp = jax.vjp(jax.jit(run), jnp.asarray(a["x"]), jnp.asarray(a["c"]))
        gx, gc = vjp((2 * ox, jnp.zeros_like(oy)))
        return dict(out_x=np.asarray(ox), out_y=np.asarray(oy, np.float32), g_x=np.asarray(gx),
                    g_c=np.asarray(gc))
    s, rows, chunks, seed = CASES[name]
    a = _inputs(s, rows, seed)
    mesh = build_mesh(MeshConfig(data_parallel=1, tensor_parallel=s), jax.devices()[:s])

    def stage_fn(p, consts, bcast, x, mbrow, mb):
        return jnp.tanh(x @ p[0] + p[1])

    def loss(w, b, x):
        out = gpipe((w, b), stage_fn, x, mesh, chunks=chunks)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a[k]) for k in "wbx"))
    return dict(out=np.asarray(out), **{f"g_{k}": np.asarray(g) for k, g in zip("wbx", grads)})


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(4, _worker, (), tmp_path_factory.mktemp("pp"))


def _close(got, want, rtol):
    err = np.linalg.norm(got.astype(np.float64) - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, err


@pytest.mark.parametrize("name", sorted(CASES) + ["multi"])
def test_gpipe_matches_jax(port, name):
    want = _jax(name)
    for rank in range(4):  # every rank of every pipeline holds the result
        got = port[rank][name]
        for k, v in want.items():
            if k == "out_y":  # bf16 leaf: the same rounding of the same fp32 sums
                np.testing.assert_allclose(got[k], v, rtol=1e-2, atol=1e-2)
            else:
                _close(got[k], v, 1e-5 if k.startswith("out") else 1e-4)


def test_gpipe_rejects_a_non_float_carry():
    import torch

    from ifseg_torch.parallel.pipeline import gpipe

    with pytest.raises(TypeError, match="mb_consts"):
        gpipe(lambda *a: a[0], [torch.zeros(4, 2, dtype=torch.int32)], None, chunks=2)


def test_gpipe_clamps_the_microbatches_with_the_jax_warning(caplog):
    import torch

    from ifseg_torch.parallel.pipeline import gpipe

    x = torch.randn(6, D)
    with caplog.at_level(logging.WARNING, logger="ifseg_torch.parallel.pipeline"):
        out = gpipe(lambda carry, *a: [carry[0] * 2], [x], None, chunks=4)[0]
    assert "clamped 4 -> 2" in caplog.text
    assert torch.equal(out, x * 2)
