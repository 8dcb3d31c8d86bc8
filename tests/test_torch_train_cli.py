"""``ifseg_torch.cli.train`` end to end on the CPU.

1. Against the JAX package's ``cli/train.py`` on the same TSVs, flags and
   weights (a complete fairseq ``.pt`` written by the JAX package's
   ``flax_to_torch_state_dict``): the tiny arch in fp32, dropout and
   drop-path 0, one epoch of 2 steps at 256 px and one validation over
   rows that need no bucket padding.  The epoch's unrounded ``loss`` and
   the validation ``nll_loss`` agree to 1e-4 relative, the predicted areas
   to 0.1 % of the pixels, the label areas exactly, and the saved
   parameters to 1e-5 absolute.
2. Two epochs straight against one epoch (a ``--max-update`` stop at the
   epoch's end) plus a resume: equal bit for bit, dropout, drop-path and an
   EMA copy on.
3. A ``--max-update`` stop inside an epoch saves a mid-epoch checkpoint with
   the cursor and no epoch-complete one (``ROADMAP.md`` C.5), and its
   resume equals the unbroken run bit for bit, the epoch's meters included.
4. ``--patience`` stops the run; 5. the reset flags, and
   ``--finetune-from-model`` with a reset flag raises; 6. ``main`` without
   ``device`` raises when there is no card; the image-free fast path
   decodes no training row; row workers give the same run.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import ifseg_torch.cli.train as ttrain
import ifseg_tpu.cli.train as jtrain
from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.checkpoint.manager import CheckpointManager
from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.data.segmentation_dataset import SegmentationDataset
from ifseg_torch.train.trainer import Trainer
from ifseg_torch.utils import metrics as tmetrics
from ifseg_tpu.checkpoint.convert import flax_to_torch_state_dict
from ifseg_tpu.cli.infer import load_params
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.models.segofa import SegOFAVariables
from ifseg_tpu.utils import metrics as jmetrics

from torch_port_utils import TINY, class_table, passed_tmp, perturb  # noqa: F401  (the fixture)
from utils import make_seg_tsv

AREAS = ("_area_intersect", "_area_pred_label", "_area_label", "_area_union")
DIMS = {k: v for k, v in TINY.items()
        if k not in ("patch_image_size", "orig_patch_image_size", "num_seg_tokens", "dtype")}


def _argv(data, save_dir, size, *extra):
    return [data, "--arch=segofa_tiny", *(f"--{k.replace('_', '-')}={v}" for k, v in DIMS.items()),
            "--num-seg-tokens=3", "--category-list=cat, dog, grass",
            f"--patch-image-size={size}", f"--orig-patch-image-size={size}",
            "--bpe-dir=assets/BPE", f"--save-dir={save_dir}", "--batch-size=2",
            "--batch-size-valid=2", "--lr=1e-3", "--log-interval=1", *extra]


@pytest.fixture(scope="module")
def tsvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    train = make_seg_tsv(str(d / "train.tsv"), rows=6, num_seg=3, size=(300, 260), seed=11)
    valid = make_seg_tsv(str(d / "valid.tsv"), rows=2, num_seg=3, size=(256, 256), seed=12)
    return f"{train},{valid}"


def _capture(monkeypatch, train_mod, metrics_mod):
    """Record each epoch's unrounded training loss (read just before the
    meters are reset) and each validation's nll_loss and summed areas."""
    seen = {"loss": [], "valid": []}
    reset, validate = metrics_mod.reset_meters, train_mod.validate

    def reset_meters(name):
        if name == "train_epoch" and metrics_mod.get_meter(name, "loss") is not None:
            seen["loss"].append(metrics_mod.get_meter(name, "loss").avg)
        reset(name)

    def wrapped_validate(*args, **kw):
        vals = validate(*args, **kw)
        got = {k: np.asarray(metrics_mod.get_meter("valid", k).sum) for k in AREAS}
        got["nll_loss"] = metrics_mod.get_meter("valid", "nll_loss").avg
        seen["valid"].append(got)
        return vals

    monkeypatch.setattr(metrics_mod, "reset_meters", reset_meters)
    monkeypatch.setattr(train_mod, "validate", wrapped_validate)
    return seen


def test_train_matches_jax(passed_tmp, tsvs, monkeypatch):
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")  # leave the tests' JAX cache alone
    weights = str(passed_tmp / "tiny.pt")
    tail = ["--max-epoch=1", f"--restore-file={weights}", "--dtype=float32", "--dropout=0.0",
            "--encoder-drop-path-rate=0.0", "--decoder-drop-path-rate=0.0"]
    train4 = make_seg_tsv(str(passed_tmp / "train4.tsv"), rows=4, num_seg=3, size=(300, 260), seed=11)
    data = f"{train4},{tsvs.split(',')[1]}"  # 4 rows: one epoch of 2 steps
    targv = _argv(data, passed_tmp / "t", 256, *tail)
    jargv = _argv(data, passed_tmp / "j", 256, *tail, "--data-parallel=1")
    jcfg = jax_flags(jargv)
    _, params = SegOFAVariables.init(jcfg.model, jax.random.PRNGKey(5))
    sd = flax_to_torch_state_dict(perturb(params, 5))
    rows, dim = sd["encoder.embed_image_positions.weight"].shape
    sd["decoder.embed_image_positions.weight"] = np.zeros((rows, dim), np.float32)
    torch.save({"model": {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}},
               weights)

    got_seen = _capture(monkeypatch, ttrain, tmetrics)
    run = ttrain.main(torch_flags(targv), device="cpu")
    want_seen = _capture(monkeypatch, jtrain, jmetrics)
    jtrain.main(jcfg)

    assert run["num_updates"] == 2 and [e["epoch"] for e in run["epochs"]] == [1]
    assert len(got_seen["loss"]) == len(want_seen["loss"]) == 1
    np.testing.assert_allclose(got_seen["loss"], want_seen["loss"], rtol=1e-4)
    got, want = got_seen["valid"][0], want_seen["valid"][0]
    np.testing.assert_allclose(got["nll_loss"], want["nll_loss"], rtol=1e-4)
    assert np.array_equal(got["_area_label"], want["_area_label"])
    pixels = want["_area_label"].sum()
    for k in ("_area_pred_label", "_area_intersect"):
        assert np.abs(got[k] - want[k]).sum() / 2 <= 1e-3 * pixels, k

    final = torch.load(passed_tmp / "t" / "checkpoint_1" / "model.pt", weights_only=True)
    jparams = state_dict_from_jax(load_params(str(passed_tmp / "j" / "checkpoint_1"), jcfg))
    for k, v in jparams.items():
        np.testing.assert_allclose(final[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)


# port-only runs: 64 px, dropout and drop-path at their defaults (0.1), an
# EMA copy validated under --uses-ema; 6 rows at batch 2 = 3 steps an epoch
RESUME = ("--patch-image-size=64", "--ema-decay=0.9", "--uses-ema")


def _main(tsvs, save_dir, *extra):
    return ttrain.main(torch_flags(_argv(tsvs, save_dir, 64, *RESUME, *extra)), device="cpu")


@pytest.fixture(scope="module")
def unbroken(request, tsvs, tmp_path_factory):
    """An unbroken 2-epoch run, removed after the module when its tests passed."""
    save_dir = tmp_path_factory.mktemp("unbroken")
    failed = request.session.testsfailed
    yield save_dir, _main(tsvs, save_dir, "--max-epoch=2")
    if request.session.testsfailed == failed:
        shutil.rmtree(save_dir, ignore_errors=True)


def _learning(stats):
    """The training meters less the host timings."""
    return {k: v for k, v in stats.items()
            if k not in ("data_wait_ms", "batch_assembly_ms", "data_stalls")}


def _same_state(a, b):
    for part in ("model.pt", "ema.pt", "optimizer.pt", "step.pt", "generator.pt"):
        x = torch.load(a / part, weights_only=True)
        y = torch.load(b / part, weights_only=True)
        assert repr(type(x)) == repr(type(y)), part
        flat = lambda t: (t.items() if isinstance(t, dict) else [("", t)])
        for (k, u), (_, v) in zip(sorted(flat(x)), sorted(flat(y))):
            if isinstance(u, dict):
                for kk in u:
                    assert torch.equal(u[kk], v[kk]), (part, k, kk)
            elif torch.is_tensor(u):
                assert torch.equal(u, v), (part, k)
            else:
                assert u == v, (part, k)


def test_resume_after_an_epoch_equals_an_unbroken_run(tsvs, passed_tmp, unbroken):
    full_dir, full = unbroken
    assert full["num_updates"] == 6 and full["best"] in ("checkpoint_1", "checkpoint_2")
    first = _main(tsvs, passed_tmp, "--max-epoch=2", "--max-update=3")
    assert first["stop"].startswith("num_updates 3") and first["num_updates"] == 3
    assert os.path.isdir(passed_tmp / "checkpoint_1")  # the epoch ran to its end: an epoch save
    second = _main(tsvs, passed_tmp, "--max-epoch=2")
    assert (second["start_epoch"], second["restored_updates"], second["num_updates"]) == (2, 3, 6)
    _same_state(full_dir / "checkpoint_2", passed_tmp / "checkpoint_2")
    assert _learning(second["epochs"][-1]["train"]) == _learning(full["epochs"][-1]["train"])
    assert second["epochs"][-1]["valid"]["mIoU"] == full["epochs"][-1]["valid"]["mIoU"]


def test_stop_inside_an_epoch_resumes_from_the_cursor(tsvs, passed_tmp, unbroken):
    full_dir, full = unbroken
    first = _main(tsvs, passed_tmp, "--max-epoch=2", "--max-update=4")
    assert first["stop"].startswith("num_updates 4")
    ckpt = CheckpointManager(torch_flags(_argv(tsvs, passed_tmp, 64)).checkpoint)
    assert ckpt.latest() == ckpt.manifest["last"] == "checkpoint_2_4"
    assert not os.path.exists(passed_tmp / "checkpoint_2")  # no epoch-complete save (C.5)
    assert ckpt.load_extra("checkpoint_2_4")["iterator"] == {
        "epoch": 2, "iterations_in_epoch": 1, "seed": 7}
    second = _main(tsvs, passed_tmp, "--max-epoch=2")
    assert (second["start_epoch"], second["resumed_iterations"], second["restored_updates"]) == (
        2, 1, 4)
    assert len(second["epochs"][0]["step_s"]) == 2
    _same_state(full_dir / "checkpoint_2", passed_tmp / "checkpoint_2")
    # the epoch's meters went with the cursor: its loss is over all 3 steps
    assert second["epochs"][-1]["train"]["loss"] == full["epochs"][-1]["train"]["loss"]


def test_row_workers_and_save_interval_give_the_same_run(tsvs, passed_tmp, unbroken):
    full_dir, _ = unbroken
    run = _main(tsvs, passed_tmp, "--max-epoch=2", "--num-workers=3", "--save-interval-updates=2",
                "--keep-interval-updates=1")
    assert [s["name"] for s in run["saves"]] == [
        "checkpoint_1_2", "checkpoint_1", "checkpoint_2_4", "checkpoint_2_6", "checkpoint_2"]
    ckpt = CheckpointManager(torch_flags(_argv(tsvs, passed_tmp, 64)).checkpoint)
    assert [i["name"] for i in ckpt.manifest["intervals"]] == ["checkpoint_2_6"]
    _same_state(full_dir / "checkpoint_2", passed_tmp / "checkpoint_2")


def test_patience_stops_the_run(tsvs, passed_tmp):
    """With lr 0 the metric never improves on epoch 1's: patience 1 ends
    the run at epoch 2 of 5."""
    run = _main(tsvs, passed_tmp, "--max-epoch=5", "--patience=1", "--lr=0.0")
    assert run["stop"] == "patience" and [e["epoch"] for e in run["epochs"]] == [1, 2]
    ckpt = CheckpointManager(torch_flags(_argv(tsvs, passed_tmp, 64)).checkpoint)
    assert ckpt.manifest["last"] == "checkpoint_2" and ckpt.manifest["best"] == "checkpoint_1"
    assert os.readlink(passed_tmp / "checkpoint_best") == "checkpoint_1"


@pytest.mark.parametrize("flag,epoch,updates,meters", [
    ("", 3, 6, True), ("--reset-optimizer", 3, 0, True), ("--reset-dataloader", 1, 6, True),
    ("--reset-meters", 3, 6, False)])
def test_reset_flags(tsvs, passed_tmp, unbroken, monkeypatch, flag, epoch, updates, meters):
    full_dir, _ = unbroken
    shutil.copytree(full_dir, passed_tmp / "ckpt", symlinks=True)
    cfg = torch_flags(_argv(tsvs, passed_tmp / "ckpt", 64, *RESUME, *[flag] * bool(flag)))
    tokens, lengths = class_table(3)
    trainer = Trainer(cfg, tokens, lengths, total_num_updates=6, device="cpu").init_state()
    loaded = []
    monkeypatch.setattr(tmetrics, "load_state_dict", loaded.append)
    start, cursor = ttrain.restore_training_state(cfg, trainer, CheckpointManager(cfg.checkpoint))
    assert (start, cursor, trainer.get_num_updates(), bool(loaded)) == (epoch, None, updates, meters)
    saved = torch.load(full_dir / "checkpoint_2" / "model.pt", weights_only=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert trainer.optimizer.count == updates


@pytest.mark.parametrize("uses_ema", [True, False])
def test_eval_weights_follow_the_ema_copy_only_when_synced(tsvs, passed_tmp, uses_ema):
    """Under --uses-ema validation reads a module of its own that holds the
    EMA weights as of the last ``sync_eval_weights``; else the training
    model itself."""
    extra = RESUME if uses_ema else ("--ema-decay=0.9",)
    cfg = torch_flags(_argv(tsvs, passed_tmp, 64, *extra))
    tokens, lengths = class_table(3)
    trainer = Trainer(cfg, tokens, lengths, total_num_updates=6, device="cpu").init_state()
    model = trainer.eval_model()
    if not uses_ema:
        assert model is trainer.model
        return
    assert model is not trainer.model
    ema = lambda: {k: v.clone() for k, v in trainer.ema.items()}
    before = ema()
    for v in trainer.ema.values():
        v.add_(1.0)
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]), k  # not yet synced
    trainer.sync_eval_weights()
    after = ema()
    assert trainer.eval_model() is model
    for k, p in model.named_parameters():
        assert torch.equal(p, after[k]), k


def test_finetune_with_a_reset_flag_raises(tsvs, passed_tmp):
    cfg = torch_flags(_argv(tsvs, passed_tmp, 64, "--finetune-from-model=w.pt", "--reset-meters"))
    with pytest.raises(ValueError, match="finetune-from-model"):
        ttrain.maybe_restore_pretrained(cfg, "cpu")
    # the layers-to-keep flags are taken now (prune_layers): without a
    # restore file there is nothing to prune and nothing is loaded
    cfg = torch_flags(_argv(tsvs, passed_tmp, 64, "--encoder-layers-to-keep=0,1"))
    assert ttrain.maybe_restore_pretrained(cfg, "cpu") is None


def test_fast_path_decodes_no_training_row(tsvs, passed_tmp, monkeypatch):
    decoded = []
    decode = SegmentationDataset._decode_row
    monkeypatch.setattr(SegmentationDataset, "_decode_row",
                        lambda self, i: decoded.append(self.split) or decode(self, i))
    run = _main(tsvs, passed_tmp, "--max-epoch=1", "--monitor-real-batch=false")
    assert run["num_updates"] == 3 and "mIoU" not in run["epochs"][0]["train"]
    assert decoded == ["valid", "valid"]  # the validation rows only


def test_main_runs_on_the_card_unless_told_otherwise(tsvs, passed_tmp):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(torch_flags(_argv(tsvs, passed_tmp, 64)))
    assert not os.path.exists(passed_tmp / "manifest.json")


def test_cli_main_reads_the_device_flag(monkeypatch):
    seen = {}
    monkeypatch.setattr(ttrain, "main", lambda cfg, device=None: seen.update(cfg=cfg, device=device))
    ttrain.cli_main(["x.tsv,y.tsv", "--device=cpu", "--max-epoch=3", "--save-dir=s"])
    assert seen["device"] == "cpu" and seen["cfg"].task.data == "x.tsv,y.tsv"
    assert seen["cfg"].optimization.max_epoch == 3 and seen["cfg"].checkpoint.save_dir == "s"
    ttrain.cli_main(["x.tsv"])
    assert seen["device"] is None
