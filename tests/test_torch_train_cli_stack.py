"""``cli.train`` with the rest of the training stack, on the CPU: the plateau
scheduler, composite groups, activation checkpointing and layer pruning.

- Three epochs under ``reduce_lr_on_plateau`` with ``--lr-patience=0``,
  ``--optimizer=composite`` (the groups take effect only with it, as in JAX),
  ``--composite-groups='decoder/.*=adam@5e-4' --composite-base=lamb`` and
  ``--remat-policy=save-attn``: the lr scale after each validation is the
  JAX package's controller on the same mIoU sequence, and a run stopped
  after epoch 2 and resumed ends in the unbroken run's state bit for bit
  (model, EMA, each group's optimizer state, the lr scale, the plateau
  controller, step, generator).
- ``--encoder/decoder-layers-to-keep`` load the kept layers of the restore
  file into a shallower model, which then trains.
"""

import torch

import ifseg_torch.cli.train as ttrain
from ifseg_torch.checkpoint.convert import prune_layers
from ifseg_torch.config import from_flags as torch_flags
from ifseg_tpu.train.optim import ReduceLROnPlateau as JaxPlateau

from test_torch_train_cli import RESUME, _argv, tsvs  # noqa: F401  (the TSV fixture)
from torch_port_utils import passed_tmp  # noqa: F401  (the fixture)

STACK = ("--lr-scheduler=reduce_lr_on_plateau", "--lr-patience=0", "--lr-shrink=0.5",
         "--optimizer=composite",
         "--composite-groups=decoder/.*=adam@5e-4", "--composite-base=lamb",
         "--checkpoint-activations=true", "--remat-policy=save-attn")


def _main(tsvs, save_dir, *extra):
    cfg = torch_flags(_argv(tsvs, save_dir, 64, *RESUME, *STACK, *extra))
    return cfg, ttrain.main(cfg, device="cpu")


def _equal(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_plateau_composite_checkpointed_run_resumes_bit_for_bit(tsvs, passed_tmp):
    cfg, full = _main(tsvs, passed_tmp / "full", "--max-epoch=3")
    assert cfg.model.checkpoint_activations and cfg.model.remat_policy == "save-attn"
    assert cfg.optimization.optimizer == "composite"
    plateau = JaxPlateau(shrink=0.5, patience=0, maximize=True)
    want = [plateau.step(float(e["valid"]["mIoU"])) for e in full["epochs"]]
    assert [e["lr_scale"] for e in full["epochs"]] == want

    _main(tsvs, passed_tmp / "split", "--max-epoch=2")
    _, resumed = _main(tsvs, passed_tmp / "split", "--max-epoch=3")
    assert (resumed["start_epoch"], resumed["restored_updates"]) == (3, 6)
    assert resumed["epochs"][-1]["lr_scale"] == full["epochs"][-1]["lr_scale"]
    parts = ("model", "ema", "optimizer", "step", "generator", "plateau")
    saved = {p: torch.load(passed_tmp / "full" / "checkpoint_3" / f"{p}.pt", weights_only=True)
             for p in parts}
    for p in parts:
        _equal(torch.load(passed_tmp / "split" / "checkpoint_3" / f"{p}.pt", weights_only=True),
               saved[p], p)
    opt = saved["optimizer"]
    assert set(opt["groups"]) == {"base", "g0"} and opt["count"] == 9
    assert "lr_scale" in opt and set(saved["plateau"]) == {"best", "bad_count", "scale"}
    assert any(k.startswith("decoder.") for k in opt["groups"]["g0"]["mu"])
    assert not any(k.startswith("decoder.") for k in opt["groups"]["base"]["mu"])


def test_layers_to_keep_prune_the_restore_file(tsvs, passed_tmp):
    _main(tsvs, passed_tmp / "deep", "--max-epoch=1")
    restore = passed_tmp / "deep" / "checkpoint_last"
    keep = ("--encoder-layers=1", "--decoder-layers=1", "--encoder-layers-to-keep=1",
            "--decoder-layers-to-keep=0", f"--restore-file={restore}")
    cfg = torch_flags(_argv(tsvs, passed_tmp / "shallow", 64, *RESUME, *STACK, *keep))
    loaded = ttrain.maybe_restore_pretrained(cfg, "cpu")
    file = torch.load(restore / "model.pt", weights_only=True)
    want = prune_layers(file, "1", "0")
    assert loaded.keys() == want.keys()
    for k in want:
        assert torch.equal(loaded[k], want[k]), k
    assert torch.equal(loaded["encoder.layers.0.fc1.weight"], file["encoder.layers.1.fc1.weight"])
    _, run = _main(tsvs, passed_tmp / "shallow", *keep, "--max-epoch=1", "--max-update=1")
    assert run["num_updates"] == 1 and run["start_epoch"] == 1
