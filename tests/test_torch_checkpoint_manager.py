"""The port's ``CheckpointManager`` against the JAX package's orbax one: the
same sequence of epoch, best and mid-epoch saves gives equal
``manifest.json`` contents and the same surviving checkpoints (the sequence
of ``tests/test_mid_epoch_checkpoint.py``, and rotations of epoch saves);
``latest()`` falls back when the newest directory is missing; a
``Trainer.state_dict()`` round trip gives the same tensors, and
``load_model`` reads a checkpoint directory (its ``checkpoint_best`` link).
"""

import json
import os

import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import load_model
from ifseg_torch.checkpoint.manager import CheckpointManager as TorchManager
from ifseg_torch.config import CheckpointConfig as TorchCkptCfg
from ifseg_torch.config import Config, model_config_for_arch
from ifseg_torch.train.trainer import Trainer
from ifseg_tpu.checkpoint.manager import CheckpointManager as JaxManager
from ifseg_tpu.config import CheckpointConfig as JaxCkptCfg

from torch_port_utils import TINY, class_table

METRICS = [0.1, 0.3, 0.2, 0.5, 0.4, 0.45]


def _run(manager_cls, cfg_cls, save_dir, sequence, **kw):
    mgr = manager_cls(cfg_cls(save_dir=str(save_dir), **kw))
    state = {"w": np.arange(4, dtype=np.float32)}
    for epoch, metric, updates in sequence:
        extra = {"epoch": epoch}
        if updates is not None:
            extra["iterator"] = {"epoch": epoch, "iterations_in_epoch": updates}
        mgr.save(epoch, state, extra=extra, val_metric=metric, updates=updates)
    mgr.finalize()
    with open(os.path.join(save_dir, "manifest.json")) as fp:
        manifest = json.load(fp)
    names = sorted(n for n in os.listdir(save_dir)
                   if os.path.isdir(os.path.join(save_dir, n))
                   and not os.path.islink(os.path.join(save_dir, n)) and not n.startswith("."))
    extras = sorted(n for n in os.listdir(save_dir) if n.endswith(".extra.json"))
    return mgr, manifest, names, extras


SEQUENCES = {
    "mid-epoch": ([(1, None, 2), (1, None, 4), (1, None, 6)], dict(keep_interval_updates=2)),
    "epochs": ([(e + 1, m, None) for e, m in enumerate(METRICS)], {}),
    "epochs-keep-3-best-2": ([(e + 1, m, None) for e, m in enumerate(METRICS)],
                             dict(keep_last_epochs=3, keep_best_checkpoints=2)),
    "epochs-minimize": ([(e + 1, m, None) for e, m in enumerate(METRICS)],
                        dict(maximize_best_checkpoint_metric=False, keep_best_checkpoints=2)),
    "mixed": ([(1, 0.2, None), (2, None, 5), (2, None, 6), (2, 0.1, None), (3, None, 9),
               (3, 0.3, None)], dict(keep_interval_updates=1, keep_last_epochs=2)),
}


@pytest.mark.parametrize("name", SEQUENCES)
def test_saves_equal_jax_manifest_and_survivors(tmp_path, name):
    sequence, kw = SEQUENCES[name]
    tmgr, tman, tnames, textras = _run(TorchManager, TorchCkptCfg, tmp_path / "t", sequence, **kw)
    jmgr, jman, jnames, jextras = _run(JaxManager, JaxCkptCfg, tmp_path / "j", sequence, **kw)
    assert tman == jman
    assert tnames == jnames and textras == jextras
    assert tmgr.latest() == jmgr.latest() and tmgr.best() == jmgr.best()
    assert tmgr.load_extra(tmgr.latest()) == jmgr.load_extra(jmgr.latest())
    for link, name_ in (("checkpoint_last", tman.get("last")), ("checkpoint_best", tman["best"])):
        if name_:
            assert os.readlink(tmp_path / "t" / link) == name_


def test_latest_falls_back_when_the_newest_directory_is_missing(tmp_path):
    """Through the epoch saves from the newest, then the mid-epoch saves, as
    the JAX manager does."""
    sequence = [(1, 0.1, None), (2, None, 7), (2, None, 8)]
    mgrs = [_run(m, c, tmp_path / d, sequence, keep_interval_updates=-1, keep_last_epochs=2)[0]
            for m, c, d in ((TorchManager, TorchCkptCfg, "t"), (JaxManager, JaxCkptCfg, "j"))]
    assert [m.latest() for m in mgrs] == ["checkpoint_2_8"] * 2
    for gone, want in (("checkpoint_2_8", "checkpoint_1"), ("checkpoint_1", "checkpoint_2_7")):
        for m, d in zip(mgrs, "tj"):
            os.rename(tmp_path / d / gone, tmp_path / d / f"gone_{gone}")
        assert [m.latest() for m in mgrs] == [want] * 2
    # a manifest read afresh falls back the same way
    assert TorchManager(TorchCkptCfg(save_dir=str(tmp_path / "t"))).latest() == "checkpoint_2_7"


def test_no_save_writes_nothing(tmp_path):
    mgr = TorchManager(TorchCkptCfg(save_dir=str(tmp_path), no_save=True))
    mgr.save(1, {"w": np.zeros(2)}, val_metric=0.5)
    assert os.listdir(tmp_path) == [] and mgr.latest() is None


def _tiny_trainer(ema: bool):
    cfg = Config()
    cfg.model = model_config_for_arch("segofa_tiny", **TINY)
    cfg.task.num_seg_tokens, cfg.task.patch_image_size = TINY["num_seg_tokens"], 64
    cfg.common.ema_decay = 0.9 if ema else 0.0
    tokens, lengths = class_table(TINY["num_seg_tokens"])
    return Trainer(cfg, tokens, lengths, total_num_updates=10, device="cpu").init_state()


@pytest.mark.parametrize("ema", [False, True], ids=["no-ema", "ema"])
def test_trainer_state_round_trip(tmp_path, ema):
    from torch_port_utils import train_batch

    trainer = _tiny_trainer(ema)
    trainer.train_step(train_batch(0))
    saved = trainer.state_dict()
    mgr = TorchManager(TorchCkptCfg(save_dir=str(tmp_path)))
    mgr.save(1, saved, extra={"epoch": 1}, val_metric=0.5)
    loaded = mgr.load("checkpoint_1")
    assert set(loaded) == ({"model", "ema", "optimizer", "step", "generator"} - (set() if ema
                                                                                 else {"ema"}))
    for k, v in saved["model"].items():
        assert torch.equal(loaded["model"][k], v), k
    for part in ("mu", "nu"):
        for k, v in saved["optimizer"][part].items():
            assert torch.equal(loaded["optimizer"][part][k], v), k
    assert loaded["optimizer"]["count"] == loaded["step"] == 1
    assert torch.equal(loaded["generator"], saved["generator"])

    other = _tiny_trainer(ema)
    other.load_state_dict(loaded)
    again = other.state_dict()
    for k, v in saved["model"].items():
        assert torch.equal(again["model"][k], v), k
    if ema:
        for k, v in saved["ema"].items():
            assert torch.equal(again["ema"][k], v), k
    # the restored trainer goes on as the first one does
    logs_a, logs_b = trainer.train_step(train_batch(1)), other.train_step(train_batch(1))
    assert torch.equal(logs_a["loss"], logs_b["loss"])
    for (k, a), b in zip(trainer.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k

    # load_model reads the directory through its link; under ema the EMA weights
    model = load_model(str(tmp_path / "checkpoint_best"), trainer.cfg.model, ema=ema)
    want = saved["ema"] if ema else saved["model"]
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
