"""FSDP gathers each unit where it computes and frees it after
(``ifseg_torch/parallel/fsdp.py``).

Two gloo processes (``torch_parallel_utils.spawn``) take one
``Trainer.train_step`` of the tiny fp32 SegOFA at fsdp 2, with the
monitoring forward, under each activation-checkpointing policy:

- at most one unit besides the root holds whole parameters at any moment
  of the step (the monitoring forward, the loss's forward, the backward's
  re-gathers, a checkpointed recompute): the module's ``WholeTracker``
  counts the gathered storages by weak reference, and nothing of them
  outlives the step;
- the all-gathers and reduce-scatters of the step, and their bytes, are
  those the units imply: each use of a unit one all-gather for each group
  of its parameters (trainable, frozen; by the dtype they travel in), each
  layer gathered again for its backward, and one reduce-scatter for each
  use of a unit with a trainable parameter;
- the step equals the JAX package's ``Trainer.train_step`` with ``fsdp=2``
  on two of the forced CPU devices, from the same weights, Adam moments and
  batch, with ``tests/test_torch_trainer.py``'s tolerances (losses 2e-5
  relative, gnorm 1e-3, lr 1e-6, confusion areas equal, each tensor's
  update within 2e-3 of the JAX update relative to its norm).

One process (a group of one, real collectives) takes the fsdp step bit for
bit equal to the unwrapped trainer's, in fp32 and in bf16 (where the
layers' linear weights travel cast).
"""

import dataclasses

import numpy as np
import pytest

from torch_parallel_utils import NUM_SEG, TINY, class_table, global_batch, rows, spawn, tiny_config

POLICIES = ("off", "full", "save-attn")
BATCH = 4
LR = 1e-3
TOTAL = 20


def _trainer(dist_cfg, mesh, policy="off", dtype="float32", strategies=None):
    from ifseg_torch.train.trainer import Trainer

    kw = {} if policy == "off" else dict(checkpoint_activations=True, remat_policy=policy)
    cfg = tiny_config(dtype=dtype, **kw)
    cfg.distributed = dist_cfg
    tokens, lengths = class_table()
    return Trainer(cfg, tokens, lengths, total_num_updates=TOTAL, device="cpu", mesh=mesh,
                   strategies=strategies).init_state()


def _units_step(policy):
    """One step at fsdp 2 after a first one: the tracker's figures, the
    step's collectives and the units' parameters."""
    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.parallel import comm
    from ifseg_torch.parallel.mesh import batch_rows, mesh_from_config

    dist_cfg = DistributedConfig(fsdp=2)
    mesh = mesh_from_config(dist_cfg, "cpu")
    tr = _trainer(dist_cfg, mesh, policy)
    batch = rows(global_batch(3, BATCH), batch_rows(BATCH, mesh))
    tr.train_step(batch)
    tracker = tr.fsdp.tracker
    comm.reset_traffic()
    tracker.reset_peak()
    tr.train_step(batch)
    units = {name: [(m._parameters[p].requires_grad, str(dt or m._parameters[p].dtype),
                     m._parameters[p].numel(), m._parameters[p].element_size(),
                     (dt or m._parameters[p].dtype).itemsize)
                    for m, p, _, dt in u.entries] for name, u in tr.fsdp.units.items()}
    return dict(alive=dict(tracker.alive), peak_units=tracker.peak_units,
                peak_bytes=tracker.peak_bytes, max_whole=tr.fsdp.max_whole_bytes(),
                traffic={k: v[:2] for k, v in comm.TRAFFIC.items()}, units=units,
                n_ranks=2)


def _jax_parity_step(state):
    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.parallel.mesh import batch_rows, mesh_from_config

    dist_cfg = DistributedConfig(fsdp=2)
    mesh = mesh_from_config(dist_cfg, "cpu")
    tr = _trainer(dist_cfg, mesh)
    tr.load_state_dict(state)
    before = {k: v.clone() for k, v in tr.state_dict()["model"].items()}
    logs = tr.train_step(rows(global_batch(11, BATCH), batch_rows(BATCH, mesh)))
    after = tr.state_dict()["model"]
    return ({k: v.numpy() for k, v in logs.items() if hasattr(v, "numpy")} | {"lr": logs["lr"]},
            {k: (after[k] - before[k]).numpy() for k in after},
            sorted(n for n, lay in tr.layouts.items() if "fsdp" in lay.values()))


def _worker(rank, world, state):
    out = {policy: _units_step(policy) for policy in POLICIES}
    out["jax"] = _jax_parity_step(state)
    return out


def _degree_one(rank, world):
    """The fsdp step on a group of one against the unwrapped trainer, from
    the same start: (loss, gnorm, whether every parameter is equal) by dtype."""
    import torch

    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.parallel.mesh import ProcessMesh

    out = {}
    batch = global_batch(3, BATCH)
    for dtype in ("float32", "bfloat16"):
        ref = _trainer(DistributedConfig(), None, dtype=dtype)
        tr = _trainer(DistributedConfig(), ProcessMesh((1, 1, 1), 0, "cpu"), dtype=dtype,
                      strategies=("fsdp",))
        assert tr.fsdp is not None and tr.fsdp.units
        got = [tr.train_step(batch) for _ in range(2)]
        want = [ref.train_step(batch) for _ in range(2)]
        mine, theirs = tr.state_dict()["model"], ref.state_dict()["model"]
        out[dtype] = dict(
            logs=[(float(g[k]), float(w[k])) for g, w in zip(got, want) for k in ("loss", "gnorm")],
            params_equal=all(torch.equal(mine[k], theirs[k]) for k in theirs))
    return out


def _jax_trainer():
    """The JAX trainer at fsdp 2 on two CPU devices, at count 3 with seeded
    moments; (trainer, params before the step, the port's whole state)."""
    import jax
    import jax.numpy as jnp

    from ifseg_torch.checkpoint.convert import adam_state_from_jax, state_dict_from_jax
    from ifseg_tpu.config import Config as JaxConfig
    from ifseg_tpu.config import model_config_for_arch
    from ifseg_tpu.models.segofa import SegOFAVariables
    from ifseg_tpu.parallel.mesh import mesh_from_config
    from ifseg_tpu.train.trainer import Trainer as JaxTrainer
    from test_torch_trainer import _with_adam_state
    from torch_port_utils import perturb

    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=model_config_for_arch("segofa_tiny", **TINY))
    jcfg.task.num_seg_tokens = NUM_SEG
    jcfg.task.patch_image_size = 64
    jcfg.optimization.lr = LR
    jcfg.distributed = dataclasses.replace(jcfg.distributed, fsdp=2)
    mesh = mesh_from_config(jcfg.distributed, devices=jax.devices()[:2])
    assert mesh.shape["fsdp"] == 2
    tokens, lengths = class_table()
    jtr = JaxTrainer(jcfg, mesh, tokens, lengths, total_num_updates=TOTAL)
    _, params = SegOFAVariables.init(jcfg.model, jax.random.PRNGKey(0))
    params = perturb(params, 0)
    jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    jtr.state = jtr.state.replace(
        step=jnp.asarray(3, jnp.int32),
        opt_state=_with_adam_state(jtr.state.opt_state, np.random.default_rng(7)))
    before = jax.device_get(jtr.state.params)
    state = {"model": state_dict_from_jax(before),
             "optimizer": adam_state_from_jax(jax.device_get(jtr.state.opt_state), before)}
    return jtr, before, state


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from ifseg_torch.checkpoint.convert import state_dict_from_jax

    jtr, before, state = _jax_trainer()
    per_rank = spawn(2, _worker, (state,), tmp_path_factory.mktemp("w2"))
    jlogs = jtr.train_step(global_batch(11, BATCH))
    after = state_dict_from_jax(jax.device_get(jtr.state.params))
    start = state_dict_from_jax(before)
    jdelta = {k: (after[k] - start[k]).numpy() for k in after}
    return per_rank, (jlogs, jdelta)


def _expected(res, policy):
    """(all-gathers, their bytes, reduce-scatters, their bytes) of the step
    from the units.  Uses without a gradient: the monitoring forward's (the
    root, the embedding twice for the text and the BOS, every layer; the
    frozen stem reads its cached folded weights) and the backward's gather
    of each layer for its tokens; with one: the loss's forward (the root,
    the embedding three times for the class means, the text and the BOS,
    every layer) and, under checkpointing, each layer's recompute in place
    of its tokens' gather.  A use is one
    all-gather for each group of its parameters (trainable or not where a
    gradient flows; by the dtype they travel in), and one reduce-scatter of
    the trainable ones' whole gradients where a gradient flows."""
    ag = agb = rs = rsb = 0
    for name, entries in res["units"].items():
        layer = ".layers." in name
        # the frozen stem's cached folded weights: its forward gathers nothing
        nograd = {"root": 1, "encoder.embed_tokens": 2, "encoder.embed_images": 0}.get(name, 1)
        grad = {"root": 1, "encoder.embed_tokens": 3, "encoder.embed_images": 0}.get(name, 1)
        recompute = int(layer and policy != "off")
        nograd += int(layer and policy == "off")
        shard_bytes = sum(numel * travel for _, _, numel, _, travel in entries)
        ag += nograd * len({dt for _, dt, _, _, _ in entries})
        ag += (grad + recompute) * len({(rg, dt) for rg, dt, _, _, _ in entries})
        agb += (nograd + grad + recompute) * shard_bytes
        trained = [e for e in entries if e[0]]
        if trained and grad:
            rs += grad
            rsb += grad * sum(numel * size * res["n_ranks"] for _, _, numel, size, _ in trained)
    return ag, agb, rs, rsb


@pytest.mark.parametrize("policy", POLICIES)
def test_one_unit_besides_the_root_is_whole_at_a_time(results, policy):
    per_rank, _ = results
    for res in (r[policy] for r in per_rank):
        assert sum(".layers." in u for u in res["units"]) == 4
        assert res["peak_units"] == 1
        assert 0 < res["peak_bytes"] <= res["max_whole"]
        assert not res["alive"], res["alive"]  # nothing gathered outlives the step


@pytest.mark.parametrize("policy", POLICIES)
def test_collectives_are_those_the_units_imply(results, policy):
    per_rank, _ = results
    for res in (r[policy] for r in per_rank):
        ag, agb, rs, rsb = _expected(res, policy)
        assert res["traffic"]["all_gather"] == [ag, agb]
        assert res["traffic"]["reduce_scatter"] == [rs, rsb]
        assert rs == 5  # the root and the four layers train; the embedding and stem are frozen


def test_fsdp2_step_equals_the_jax_step(results):
    per_rank, (jlogs, jdelta) = results
    for logs, delta, split in (r["jax"] for r in per_rank):
        assert any(".layers." in n for n in split) and "encoder.embed_tokens.weight" in split
        for key in ("loss", "imfree_loss", "seg_loss", "nll_loss"):
            np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=2e-5,
                                       err_msg=key)
        np.testing.assert_allclose(float(logs["gnorm"]), float(jlogs["gnorm"]), rtol=1e-3)
        np.testing.assert_allclose(float(logs["lr"]), float(jlogs["lr"]), rtol=1e-6)
        for key in jlogs:
            if key.startswith("area_"):
                np.testing.assert_array_equal(logs[key], np.asarray(jlogs[key]), err_msg=key)
        moved = 0
        for name, want in jdelta.items():
            err, ref = np.linalg.norm(delta[name] - want), np.linalg.norm(want)
            assert err <= 2e-3 * ref + 1e-9, f"{name}: {err} vs {ref}"
            moved += ref > 0
        assert moved > 100


@pytest.fixture(scope="module")
def degree_one(tmp_path_factory):
    return spawn(1, _degree_one, (), tmp_path_factory.mktemp("w1"))[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fsdp_at_degree_one_is_bit_equal_to_the_unwrapped_step(degree_one, dtype):
    res = degree_one[dtype]
    for got, want in res["logs"]:
        assert got == want, (got, want)
    assert res["params_equal"]
