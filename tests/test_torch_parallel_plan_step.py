"""One ``Trainer.train_step`` under the model axis's programs.

The pipeline (``pipeline_parallel=2``, at 2 and 4 microbatches, the second
with full activation checkpointing inside the stages) and the ring
(``context_parallel=2``; the decoder's 17 tokens padded to 18) on two
processes over gloo, against the one-process step on the same 4 rows, with
PR 13's harness and tolerances (``test_torch_parallel_step.py``): loss,
monitoring loss and gnorm within 1e-5 relative, the confusion areas equal,
the parameters within 1e-5 relative and the update within 1e-4 relative
beyond the fp32 resolution.

The experts (``moe_experts=2``, ``moe_freq=2``: the second layer of each
side) have no one-process step to compare with: the two ranks' step is held
against the JAX package's ``Trainer.train_step`` on its 2-device mesh, from
the same weights (``state_dict_from_jax``) and Adam moments
(``adam_state_from_jax``): the losses within 1e-5 relative, gnorm within
1e-4, the confusion areas equal, and each tensor's update within 1e-4 of
the JAX update (relative to its norm).  Each process
count is spawned once for the file.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_parallel_step import BATCH, _run_case
from torch_parallel_utils import class_table, global_batch, rows, spawn, tiny_config

CASES = {
    "pipeline2-chunks2": dict(dist=dict(pipeline_parallel=2, pipeline_chunks=2)),
    "pipeline2-chunks4-full": dict(dist=dict(pipeline_parallel=2, pipeline_chunks=4),
                                   model=dict(checkpoint_activations=True, remat_policy="full")),
    "context2": dict(dist=dict(context_parallel=2)),
}
LR = 1e-3


def _moe_step(state):
    import torch

    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.parallel.mesh import batch_rows, mesh_from_config
    from ifseg_torch.train.trainer import Trainer

    cfg = tiny_config()
    cfg.optimization.lr = LR
    cfg.optimization.total_num_update = 0
    cfg.distributed = DistributedConfig(moe_experts=2, moe_freq=2)
    mesh = mesh_from_config(cfg.distributed, "cpu")
    tokens, lengths = class_table()
    tr = Trainer(cfg, tokens, lengths, total_num_updates=20, device="cpu", mesh=mesh).init_state()
    tr.load_state_dict(state)
    before = {k: v.clone() for k, v in tr.state_dict()["model"].items()}
    batch = global_batch(11, BATCH)
    logs = tr.train_step(rows(batch, batch_rows(BATCH, mesh)))
    after = tr.state_dict()["model"]
    return ({k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in logs.items()},
            {k: (after[k] - before[k]).numpy() for k in after}, sorted(tr.layouts))


def _worker(rank, world, names, moe_state):
    out = {name: _run_case(CASES[name]) for name in names}
    out["moe"] = _moe_step(moe_state)
    return out


def _jax_moe_trainer():
    """The JAX trainer with two experts on a 2-device mesh, its state at
    count 3 with seeded moments; (trainer, params before the step, the
    port's whole state)."""
    import jax
    import jax.numpy as jnp

    from ifseg_torch.checkpoint.convert import adam_state_from_jax, state_dict_from_jax
    from ifseg_tpu.config import Config as JaxConfig
    from ifseg_tpu.config import model_config_for_arch
    from ifseg_tpu.models.segofa import SegOFAVariables
    from ifseg_tpu.parallel.mesh import mesh_from_config
    from ifseg_tpu.train.trainer import Trainer as JaxTrainer
    from torch_parallel_utils import NUM_SEG, TINY
    from test_torch_trainer import _with_adam_state
    from torch_port_utils import perturb

    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=model_config_for_arch("segofa_tiny", **TINY))
    jcfg.task.num_seg_tokens = NUM_SEG
    jcfg.task.patch_image_size = 64
    jcfg.optimization.lr = LR
    jcfg.distributed = dataclasses.replace(jcfg.distributed, moe_experts=2, moe_freq=2)
    mesh = mesh_from_config(jcfg.distributed, devices=jax.devices()[:2])
    tokens, lengths = class_table()
    jtr = JaxTrainer(jcfg, mesh, tokens, lengths, total_num_updates=20)
    _, params = SegOFAVariables.init(jcfg.model, jax.random.PRNGKey(0), plan=jtr.plan)
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
    jtr, before, state = _jax_moe_trainer()
    per_rank = spawn(2, _worker, (sorted(CASES), state), tmp_path_factory.mktemp("w2"))
    import jax

    from ifseg_torch.checkpoint.convert import state_dict_from_jax

    jlogs = jtr.train_step(global_batch(11, BATCH))
    after = state_dict_from_jax(jax.device_get(jtr.state.params))
    start = state_dict_from_jax(before)
    jax_moe = (jlogs, {k: (after[k] - start[k]).numpy() for k in after})
    return per_rank, jax_moe


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_axis_step_equals_one_process(results, name):
    for res in (r[name] for r in results[0]):
        for k in ("loss", "gnorm", "nll_loss"):
            got, want = res[k]
            assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
        assert res["areas_equal"]
        assert res["param_rel"] <= 1e-5, res["param_rel"]
        assert res["update_rel"] <= 1.0, res["update_rel"]
        assert res["n_updated"] >= 2


def test_expert_step_equals_the_jax_step(results):
    per_rank, (jlogs, jdelta) = results
    for logs, delta, layouts in (r["moe"] for r in per_rank):
        assert any(".moe.wi" in k for k in layouts)
        for key in ("loss", "imfree_loss", "seg_loss", "nll_loss"):
            np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=1e-5,
                                       err_msg=key)
        np.testing.assert_allclose(float(logs["gnorm"]), float(jlogs["gnorm"]), rtol=1e-4)
        for key in jlogs:
            if key.startswith("area_"):
                np.testing.assert_array_equal(logs[key], np.asarray(jlogs[key]), err_msg=key)
        assert set(delta) >= set(jdelta)
        moved = 0
        for name, want in jdelta.items():
            err, ref = np.linalg.norm(delta[name] - want), np.linalg.norm(want)
            assert err <= 1e-4 * ref + 1e-9, f"{name}: {err} vs {ref}"
            moved += ".moe." in name and ref > 0
        assert moved == 6  # centroids, wi, wo of both sides' expert layer
