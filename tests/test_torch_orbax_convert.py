"""``tools/orbax_to_torch.py``: save directories of the JAX package's
``CheckpointManager`` (orbax) converted for the port, CPU, fp32, tiny widths.

- A JAX ``Trainer`` takes 2 steps with an EMA copy; the JAX manager saves an
  interval checkpoint after the first and an epoch checkpoint after the
  second.  Converted, every checkpoint restores into the port's ``Trainer``
  bit for bit equal to ``state_dict_from_jax`` of the JAX state (model, EMA,
  Adam's moments), with the same count and step, the manifest, the links
  and the extra files carried over.
- Every optimizer's state: ``tests/test_torch_orbax_optimizers.py``.
- A save whose arrays are sharded over the conftest's 8 CPU devices (FSDP,
  written as the manager writes under several processes) converts to the
  same tensors as the unsharded save of the same state.
- A JAX ``cli.train`` epoch (the tiny command of the verify notes,
  ``--max-epoch=1``), converted, resumes in the port's ``cli.train`` at
  epoch 2 with its updates and meters restored.
- A checkpoint that was never committed, flags that build another tree and
  a port directory that is not empty are refused, and nothing is written
  (a directory of the staging name beside the target is left alone).
- The converted state has no generator: the port's trainer seeds its
  dropout generator with seed + step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import optimizer_state_from_jax, state_dict_from_jax
from ifseg_torch.checkpoint.manager import CheckpointManager as PortManager
from ifseg_torch.config import from_flags as port_flags
from ifseg_tpu.checkpoint.manager import CheckpointManager as JaxManager
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.parallel.mesh import MeshConfig, build_mesh
from ifseg_tpu.train import optim as jo
from ifseg_tpu.train.ema import ema_init
from ifseg_tpu.train.trainer import TrainState
from ifseg_tpu.train.trainer import Trainer as JaxTrainer

from torch_orbax_utils import (NUM_SEG, TOTAL, flags, port_trainer, restore, seeded_grads,
                               tiny_params, tool, trace_each_model_once)  # noqa: F401
from torch_port_utils import class_table, passed_tmp, train_batch  # noqa: F401  (the fixture)


def _trainer_state_equal(trainer, host, names):
    """The port trainer's restored state equals ``state_dict_from_jax`` of
    the JAX state ``host`` bit for bit."""
    model = state_dict_from_jax(host.params)
    assert all(torch.equal(v, model[k]) for k, v in trainer.model.state_dict().items())
    shadow = state_dict_from_jax(host.ema_params)
    assert all(torch.equal(v, shadow[k]) for k, v in trainer.ema.items())
    opt = trainer.optimizer.state_dict()
    adam = optimizer_state_from_jax(host.opt_state, host.params, trainer.optimizer)
    assert opt["count"] == adam["count"] == int(host.step) == trainer.get_num_updates()
    for m in ("mu", "nu"):
        assert all(torch.equal(opt[m][n], adam[m][n]) for n in names), m
    assert any(adam["mu"][n].any() for n in names)


def test_trainer_checkpoints_convert_bit_for_bit(passed_tmp):
    """A JAX Trainer's interval and epoch checkpoints, with EMA."""
    argv = flags(passed_tmp / "jax", "--optimizer=adam")
    jcfg = jax_flags(argv)
    tokens, lengths = class_table(NUM_SEG)
    mesh = build_mesh(MeshConfig(data_parallel=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(jcfg, mesh, tokens, lengths, total_num_updates=TOTAL)
    jtr.init_state(jax.tree_util.tree_map(jnp.asarray, tiny_params()))
    # ema_init shares the parameters' buffers, which the step donates twice
    jtr.state = jtr.state.replace(ema_params=jax.tree_util.tree_map(jnp.copy,
                                                                    jtr.state.ema_params))
    jmgr = JaxManager(jcfg.checkpoint)
    snapshots = {}
    jtr.train_step(train_batch(seed=1, num_seg=NUM_SEG))
    jmgr.save(1, jtr.state, extra={"epoch": 1, "iterator": {"epoch": 1, "iterations_in_epoch": 1,
                                                           "seed": 1}}, updates=1)
    snapshots["checkpoint_1_1"] = jax.device_get(jtr.state)
    jtr.train_step(train_batch(seed=2, num_seg=NUM_SEG))
    jmgr.save(1, jtr.state, extra={"epoch": 1, "metrics": {}}, val_metric=0.25)
    snapshots["checkpoint_1"] = jax.device_get(jtr.state)
    jmgr.finalize()

    out = tool.convert(str(passed_tmp / "jax"), str(passed_tmp / "port"), argv)
    assert out == {"converted": ["checkpoint_1", "checkpoint_1_1"], "last": "checkpoint_1",
                   "best": "checkpoint_1"}
    port = passed_tmp / "port"
    assert json.loads((port / "manifest.json").read_text()) == jmgr.manifest
    assert os.readlink(port / "checkpoint_last") == os.readlink(port / "checkpoint_best") == \
        "checkpoint_1"
    for name in snapshots:
        assert (port / f"{name}.extra.json").read_bytes() == \
            (passed_tmp / "jax" / f"{name}.extra.json").read_bytes()
        assert sorted(p.name for p in (port / name).iterdir()) == [
            "ema.pt", "model.pt", "optimizer.pt", "step.pt"]
    for name, host in snapshots.items():
        trainer = port_trainer(argv)
        restore(trainer, str(port), name)
        _trainer_state_equal(trainer, host, trainer.optimizer.names)
        seed = trainer.cfg.optimization.seed + int(host.step)
        assert torch.equal(trainer.generator.get_state(),
                           torch.Generator().manual_seed(seed).get_state())


def test_sharded_save_converts_as_the_unsharded_one(passed_tmp):
    """The same state saved whole and saved as FSDP shards over 8 devices."""
    argv = flags(passed_tmp / "whole", "--optimizer=adam")
    jcfg = jax_flags(argv)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(jnp.asarray, tiny_params())
    tx, _, _ = jo.build_optimizer(params, jcfg.model, jcfg.optimization, TOTAL)
    state = tx.init(params)
    _, state = tx.update(seeded_grads(params, rng), state, params)
    host = TrainState(step=jnp.asarray(1, jnp.int32), params=params, opt_state=state,
                      ema_params=ema_init(params))
    whole = JaxManager(jcfg.checkpoint)
    whole.save(1, host, extra={"epoch": 1})
    whole.finalize()

    fcfg = jax_flags(flags(passed_tmp / "sharded", "--optimizer=adam", "--fsdp=8",
                            "--data-parallel=1"))
    tokens, lengths = class_table(NUM_SEG)
    mesh = build_mesh(MeshConfig(data_parallel=1, fsdp=8), devices=jax.devices()[:8])
    jtr = JaxTrainer(fcfg, mesh, tokens, lengths, total_num_updates=TOTAL)
    jtr.init_state(params)
    sharded = jax.device_put(host, jtr.state_shardings)
    jmgr = JaxManager(fcfg.checkpoint)
    jmgr.save(1, sharded, extra={"epoch": 1})
    # as the manager writes under several processes: the sharded arrays, not a host copy
    jmgr._ckptr.save(jmgr._path("checkpoint_1"), {"state": sharded}, force=True)
    jmgr.finalize()
    meta = tool.ocp.StandardCheckpointer().metadata(str(passed_tmp / "sharded" / "checkpoint_1"))
    kernel = meta.item_metadata.tree["state"]["params"]["encoder"]["layers_0"]["ffn"]["fc1"]
    assert tuple(kernel["kernel"].sharding.partition_spec) == (None, "fsdp")
    assert np.prod(kernel["kernel"].sharding.shape) == 8

    for d in ("whole", "sharded"):
        tool.convert(str(passed_tmp / d), str(passed_tmp / f"{d}_port"), argv)
    for f in ("model.pt", "ema.pt", "optimizer.pt", "step.pt"):
        a = torch.load(passed_tmp / "whole_port" / "checkpoint_1" / f, weights_only=True)
        b = torch.load(passed_tmp / "sharded_port" / "checkpoint_1" / f, weights_only=True)
        assert _same(a, b), f


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    return a == b


def _saved_run(passed_tmp):
    argv = flags(passed_tmp / "jax", "--optimizer=adam")
    jcfg = jax_flags(argv)
    params = jax.tree_util.tree_map(jnp.asarray, tiny_params())
    tx, _, _ = jo.build_optimizer(params, jcfg.model, jcfg.optimization, TOTAL)
    jmgr = JaxManager(jcfg.checkpoint)
    jmgr.save(1, TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                            opt_state=tx.init(params), ema_params=ema_init(params)),
              extra={"epoch": 1})
    jmgr.finalize()
    return argv


def test_refuses_and_writes_nothing(passed_tmp):
    argv = _saved_run(passed_tmp)
    jax_dir, port = str(passed_tmp / "jax"), passed_tmp / "port"
    # a user's directory of the staging name beside the target is left alone
    (passed_tmp / "port.partial").mkdir()
    (passed_tmp / "port.partial" / "mine").write_text("y")
    # another optimizer, another width: another tree
    for other in (["--optimizer=sgd"], ["--encoder-ffn-embed-dim=96"]):
        with pytest.raises(tool.RefusedError, match="does not match the checkpoint"):
            tool.convert(jax_dir, str(port), argv + other)
        assert not port.exists() and sorted(os.listdir(passed_tmp)) == ["jax", "port.partial"]
    port.mkdir()
    (port / "keep").write_text("x")
    with pytest.raises(tool.RefusedError, match="not empty"):
        tool.convert(jax_dir, str(port), argv)
    assert os.listdir(port) == ["keep"]
    # an asynchronous save that never committed: orbax's temporary directory
    # holds it, the manifest already names it
    os.rename(passed_tmp / "jax" / "checkpoint_1",
              passed_tmp / "jax" / "checkpoint_1.orbax-checkpoint-tmp-1234")
    with pytest.raises(tool.RefusedError, match="never committed"):
        tool.convert(jax_dir, str(passed_tmp / "port2"), argv)
    assert not (passed_tmp / "port2").exists()
    with pytest.raises(SystemExit, match="never committed"):
        tool.main([jax_dir, str(passed_tmp / "port2"), *argv])
    os.rename(passed_tmp / "jax" / "checkpoint_1.orbax-checkpoint-tmp-1234",
              passed_tmp / "jax" / "checkpoint_1")
    tool.convert(jax_dir, str(passed_tmp / "port2"), argv)
    assert (passed_tmp / "port.partial" / "mine").read_text() == "y"
    assert sorted(os.listdir(passed_tmp)) == ["jax", "port", "port.partial", "port2"]


def test_a_converted_state_seeds_the_generator_from_the_step(passed_tmp):
    """A state with a step and no generator (the converter's) seeds the
    dropout generator with seed + step on every data rank's rule; a saved
    generator is taken as it is on rank 0."""
    argv = flags(passed_tmp / "x", "--optimizer=adam")
    trainer = port_trainer(argv)
    seed = trainer.cfg.optimization.seed
    trainer.load_state_dict({"step": 7})
    assert torch.equal(trainer.generator.get_state(),
                       torch.Generator().manual_seed(seed + 7).get_state())
    saved = torch.Generator().manual_seed(123).get_state()
    trainer.load_state_dict({"step": 9, "generator": saved})
    assert trainer.step == 9 and torch.equal(trainer.generator.get_state(), saved)


# the tiny command of the verify notes (.claude/skills/verify/SKILL.md)
SKILL_FLAGS = ("--arch=segofa_tiny", "--encoder-embed-dim=32", "--encoder-ffn-embed-dim=64",
               "--encoder-layers=2", "--encoder-attention-heads=4", "--decoder-embed-dim=32",
               "--decoder-ffn-embed-dim=64", "--decoder-layers=2", "--decoder-attention-heads=4",
               "--resnet-type=resnet50", "--num-seg-tokens=3", "--category-list=cat, dog, grass",
               "--patch-image-size=32", "--orig-patch-image-size=32", "--batch-size=2",
               "--lr=1e-3", "--dropout=0.0", "--encoder-drop-path-rate=0.0",
               "--decoder-drop-path-rate=0.0", "--bpe-dir=assets/BPE", "--log-interval=1",
               "--data-parallel=1")


def test_a_jax_cli_epoch_resumes_in_the_port_cli(passed_tmp, monkeypatch):
    import ifseg_torch.cli.train as ttrain
    import ifseg_tpu.cli.train as jtrain
    from ifseg_torch.utils import metrics as tmetrics

    from utils import make_seg_tsv

    monkeypatch.setenv("IFSEG_JIT_CACHE", "")  # leave the tests' JAX cache alone
    train = make_seg_tsv(str(passed_tmp / "train.tsv"), rows=4, seed=11)
    valid = make_seg_tsv(str(passed_tmp / "valid.tsv"), rows=2, seed=12)
    argv = [f"{train},{valid}", *SKILL_FLAGS]
    # no validation in the JAX epoch (its evaluator's compile is most of the
    # cost); the port validates its own epoch
    jtrain.main(jax_flags(argv + ["--max-epoch=1", "--validate-interval=2",
                                  f"--save-dir={passed_tmp / 'jax'}"]))
    extra = json.loads((passed_tmp / "jax" / "checkpoint_1.extra.json").read_text())

    port = str(passed_tmp / "port")
    assert tool.convert(str(passed_tmp / "jax"), port, argv)["last"] == "checkpoint_1"
    restored = {}
    cli_restore = ttrain.restore_training_state

    def recording_restore(cfg, trainer, ckpt):
        out = cli_restore(cfg, trainer, ckpt)
        restored.update(meters=json.loads(json.dumps(tmetrics.state_dict())),
                        updates=trainer.get_num_updates())
        return out

    monkeypatch.setattr(ttrain, "restore_training_state", recording_restore)
    run = ttrain.main(port_flags(argv + ["--max-epoch=2", f"--save-dir={port}"]), device="cpu")
    assert (run["start_epoch"], run["restored_updates"], run["num_updates"]) == (2, 2, 4)
    assert [e["epoch"] for e in run["epochs"]] == [2] and run["epochs"][0]["valid"] is not None
    assert restored["updates"] == 2
    assert extra["metrics"] and all(restored["meters"][k] == v
                                    for k, v in extra["metrics"].items())
    assert PortManager(port_flags(argv).checkpoint, save_dir=port).manifest["last"] == \
        "checkpoint_2"
