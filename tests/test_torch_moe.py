"""The port's BASE mixture-of-experts layer (``ifseg_torch.parallel.moe``)
against the JAX package's ``base_moe_layer`` on the virtual CPU mesh.

Four gloo ranks, spawned once for the file, form a (data 2, fsdp 1,
model 2) mesh: each data shard's rows enter both ranks of its expert group,
each rank holds one expert.  The same numpy-seeded experts and tokens go
through the JAX function on the same mesh shape; with both assignments:
the output within 1e-5 relative, and the gradients of sum(out²) with
respect to the tokens and the experts within 1e-4 relative (the experts'
summed over the data ranks, as the trainer sums them).  Rows that do not
split raise.
"""

import numpy as np
import pytest

from torch_parallel_utils import spawn
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

D, F, TOKENS = 16, 32, 64


def _inputs():
    rng = np.random.default_rng(0)
    p = {"centroids": rng.normal(size=(2, D)) * D ** -0.5,
         "wi": rng.normal(size=(2, D, F)) * D ** -0.5,
         "wo": rng.normal(size=(2, F, D)) * F ** -0.5}
    x = rng.normal(size=(TOKENS, D))
    return {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


def _worker(rank, world):
    import torch

    from ifseg_torch.parallel.comm import all_reduce
    from ifseg_torch.parallel.mesh import ProcessMesh
    from ifseg_torch.parallel.moe import base_moe_layer

    mesh = ProcessMesh((2, 1, 2), rank)
    d, m = mesh.index("batch"), mesh.index("model")
    p, x = _inputs()
    out = {}
    for assignment in ("sinkhorn", "auction"):
        local = {k: torch.tensor(v[m:m + 1], requires_grad=True) for k, v in p.items()}
        per = TOKENS // 2
        xs = torch.tensor(x[d * per:(d + 1) * per], requires_grad=True)
        y = base_moe_layer(local, xs, mesh.group("model"), assignment)
        (y ** 2).sum().backward()
        out[assignment] = dict(
            out=y.detach().numpy(), g_x=xs.grad.numpy(),
            **{f"g_{k}": all_reduce(v.grad, mesh.group("batch")).numpy()
               for k, v in local.items()})
    try:
        base_moe_layer(local, torch.zeros(6, D), mesh.group("model"))
        out["raises"] = False
    except ValueError as e:
        out["raises"] = "pad the token axis" in str(e)
    return dict(data=d, model=m, **out)


def _jax(assignment, monkeypatch):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ifseg_tpu.ops.balanced_assignment import balanced_assignment_auction
    from ifseg_tpu.parallel import moe as jmoe
    from ifseg_tpu.parallel.mesh import MeshConfig, build_mesh
    from ifseg_tpu.parallel.moe import base_moe_layer, moe_param_shardings

    # the auction is a host callback, which jax.grad cannot differentiate
    # through even though its integer ids carry no gradient: the same ids
    # from scores with their (zero) tangent cut
    monkeypatch.setattr(jmoe, "balanced_assignment_auction",
                        lambda s: balanced_assignment_auction(jax.lax.stop_gradient(s)))

    p, x = _inputs()
    mesh = build_mesh(MeshConfig(data_parallel=2, tensor_parallel=2), jax.devices()[:4])
    params = jax.device_put({k: jnp.asarray(v) for k, v in p.items()}, moe_param_shardings(mesh))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(("data", "fsdp"), None)))

    def loss(params, x):
        y = base_moe_layer(params, x, mesh, assignment=assignment)
        return jnp.sum(y ** 2), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, xs)
    return np.asarray(y), np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(4, _worker, (), tmp_path_factory.mktemp("moe"))


def _close(got, want, rtol):
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, err


@pytest.mark.parametrize("assignment", ["sinkhorn", "auction"])
def test_base_moe_layer_matches_jax(port, assignment, monkeypatch):
    y, gx, gp = _jax(assignment, monkeypatch)
    per = TOKENS // 2
    for res in port:
        got, rows = res[assignment], slice(res["data"] * per, (res["data"] + 1) * per)
        _close(got["out"], y[rows], 1e-5)
        _close(got["g_x"], gx[rows], 1e-4)
        for k in ("centroids", "wi", "wo"):
            _close(got[f"g_{k}"], gp[k][res["model"]:res["model"] + 1], 1e-4)


def test_rows_that_do_not_split_raise(port):
    assert all(res["raises"] for res in port)
