"""The port's process layout and sharding rules against the JAX package's.

- rank -> (data, fsdp, model) coordinate equals the device -> coordinate of
  the JAX ``build_mesh`` on the 8-device CPU mesh of ``tests/conftest.py``,
  for the layouts (8,1,1), (2,2,2) and (4,1,2);
- for every parameter of a tiny SegOFA, the port's split dims (TP over
  'model', FSDP over 'fsdp') equal the JAX ``param_shardings`` spec
  translated to the torch layout (flax kernels are (in, out), torch weights
  (out, in); HWIO against OIHW; the stacked relative-position tables), and
  ZeRO-1's optimizer-state placement over 'data' equals the JAX
  ``opt_state_shardings``;
- ``param_fingerprint`` and ``global_grad_norm`` equal the JAX functions on
  the same numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ifseg_torch.parallel.mesh import MeshConfig, mesh_shape, rank_coord
from ifseg_torch.parallel.sharding import _view_to_torch, model_layouts
from ifseg_torch.train.optim import jax_paths
from ifseg_torch.utils import reliability as treli
from ifseg_tpu.parallel import mesh as jmesh
from ifseg_tpu.parallel.sharding import opt_state_shardings, param_shardings
from ifseg_tpu.utils import reliability as jreli

from torch_port_utils import make_pair

LAYOUTS = [(8, 1, 1), (2, 2, 2), (4, 1, 2)]


@pytest.fixture(scope="module")
def pair():
    _, params, model = make_pair(0)
    return params, model


def _mesh(layout):
    dp, fs, tp = layout
    return jmesh.build_mesh(jmesh.MeshConfig(dp, fs, tp), devices=jax.devices()[:8])


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{a}x{b}x{c}" for a, b, c in LAYOUTS])
def test_rank_coordinates_are_the_jax_meshs(layout):
    dp, fs, tp = layout
    devices = list(jax.devices()[:8])
    jm = _mesh(layout)
    for coord in np.ndindex(dp, fs, tp):
        rank = devices.index(jm.devices[coord])
        assert rank_coord(rank, layout) == coord
    assert mesh_shape(MeshConfig(-1, fs, tp), 8) == layout


def _leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _torch_spec(spec, ndim_view, layout, ndim_torch):
    to_torch = _view_to_torch(layout, ndim_torch)
    spec = tuple(spec) + (None,) * (ndim_view - len(spec))
    return {to_torch[v]: a for v, a in enumerate(spec) if a is not None and to_torch[v] is not None}


def _compare(params, model, jax_specs, mesh_dims, axes):
    """The port's layouts over the mesh dims ``axes`` of size above 1 (as
    a configured run asks for them) against the JAX specs, parameter by
    parameter; the decoder's image position table, which only the port
    holds, has none."""
    paths = jax_paths(model)
    ours = model_layouts(model, mesh_dims, axes=[a for a in axes if mesh_dims[a] > 1])
    checked = 0
    for name, p in model.named_parameters():
        path, layout = paths[name]
        try:
            _leaf(params, path)
        except KeyError:
            assert name == "decoder.embed_image_positions.weight", name
            continue
        spec, view_ndim = jax_specs(path)
        want = _torch_spec(spec, view_ndim, layout, p.dim())
        assert ours[name] == want, (name, path, ours[name], want)
        checked += bool(want)
    return checked


@pytest.mark.parametrize("layout", LAYOUTS[1:], ids=["2x2x2", "4x1x2"])
def test_tp_and_fsdp_splits_are_the_jax_param_shardings(pair, layout):
    params, model = pair
    shardings = param_shardings(params, _mesh(layout))
    dims = dict(zip(("data", "fsdp", "model"), layout))

    def specs(path):
        return _leaf(shardings, path).spec, np.ndim(_leaf(params, path))

    assert _compare(params, model, specs, dims, ("model", "fsdp")) > 20
    # the TP split lands on the torch weight's output dim for q_proj and on
    # its input dim for out_proj
    ours = model_layouts(model, dims, axes=("model",))
    assert ours["encoder.layers.0.self_attn.q_proj.weight"] == {0: "model"}
    assert ours["encoder.layers.0.self_attn.out_proj.weight"] == {1: "model"}
    assert ours["encoder.embed_tokens.weight"] == {0: "model"}
    assert ours["encoder.image_proj.weight"] == {0: "model"}


@pytest.mark.parametrize("layout", LAYOUTS, ids=[f"{a}x{b}x{c}" for a, b, c in LAYOUTS])
def test_zero1_state_placement_is_the_jax_opt_state_shardings(pair, layout):
    params, model = pair
    state = optax.scale_by_adam().init(params)
    shardings = opt_state_shardings(state, _mesh(layout), zero1=True)
    dims = dict(zip(("data", "fsdp", "model"), layout))

    def specs(path):
        return _leaf(shardings.mu, path).spec, np.ndim(_leaf(params, path))

    assert _compare(params, model, specs, dims, ("model", "fsdp", "data")) > 10


def test_param_fingerprint_is_the_jax_fingerprint():
    rng = np.random.default_rng(0)
    arrays = {"encoder/layers_0/fc1/kernel": rng.normal(size=(8, 16)),
              "encoder/layers_0/fc1/bias": rng.normal(size=(16,)),
              "decoder/seg_embed_tokens": rng.normal(size=(5, 8)),
              "encoder/layers_10/fc1/bias": rng.normal(size=(16,)),
              "encoder/layers_2/fc1/bias": rng.normal(size=(16,))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    tree = {}
    for path, v in arrays.items():
        node = tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = jnp.asarray(v)
    want = float(jreli.param_fingerprint(tree))
    got = treli.param_fingerprint({k: torch.from_numpy(v) for k, v in arrays.items()})
    assert got == pytest.approx(want, rel=1e-6)


def test_global_grad_norm_is_the_jax_norm():
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    want = float(jreli.global_grad_norm([jnp.asarray(g) for g in grads]))
    got = float(treli.global_grad_norm([torch.from_numpy(g) for g in grads]))
    assert got == pytest.approx(want, rel=1e-6)
