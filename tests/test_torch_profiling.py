"""The port's ``utils/profiling.py``, ``tasks/registry.py`` and the progress
bar's TensorBoard and W&B mirrors against the JAX package's (CPU).

- The same step durations flag the same steps in both watchdogs.
- ``span`` shows in a CPU ``torch.profiler`` trace, ``profile_to`` writes a
  Chrome trace that holds it, and ``profile_to(None)`` traces nothing.
- The registries' duplicate and unknown-name errors are the JAX package's,
  and ``setup_task("segmentation", cfg)`` builds the port's task.
- Both TensorBoard mirrors, fed the same ``log`` / ``print`` calls, write
  files that TensorBoard's own event loader reads as equal (tag, step,
  value) lists; the port's file frames each record with both CRC-32Cs.
- A fake ``wandb`` module receives the same ``init`` and ``log`` calls from
  both wrappers; without the package both log the same warning and mirror
  nothing.
- ``cli.train`` on the CPU with ``--tensorboard-logdir`` under
  ``profile_to``: one ``train_step-{i}`` span an update in the trace, and
  the event file's scalars equal the stats it logged.
"""

import glob
import json
import logging
import os
import struct
import sys
import types

import numpy as np
import pytest
import torch

from ifseg_torch.config import Config as TorchConfig
from ifseg_torch.tasks import registry as treg
from ifseg_torch.tasks.segmentation import SegmentationTask as TorchTask
from ifseg_torch.utils import profiling as tprof
from ifseg_torch.utils import progress as tprogress
from ifseg_torch.utils import tb_events
from ifseg_tpu.config import Config as JaxConfig
from ifseg_tpu.tasks import registry as jreg
from ifseg_tpu.utils import profiling as jprof
from ifseg_tpu.utils import progress as jprogress

from utils import make_seg_tsv
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

DURATIONS = [
    [5.0, 4.0, 3.0] + [0.1] * 6 + [1.2, 0.1, 0.9, 0.11] + [0.1] * 60 + [2.0, 0.5, 0.05],
    [0.2] * 9 + [3.0, 0.2, 2.5, 1.9, 2.1] + [0.2] * 5,
    [1e-9] * 8 + [1e-5, 2e-5],
]


@pytest.mark.parametrize("durations", DURATIONS, ids=["long", "short", "tiny"])
@pytest.mark.parametrize("kw", [{}, dict(warmup_steps=1, threshold=4.0)], ids=["default", "tight"])
def test_watchdogs_flag_the_same_steps(durations, kw):
    j, t = jprof.CompilationWatchdog(**kw), tprof.CompilationWatchdog(**kw)
    flagged = [t.step(d) for d in durations]
    assert flagged == [j.step(d) for d in durations]
    assert any(flagged) and t._warned == j._warned == sum(flagged)


def test_step_timer_times_the_block_and_feeds_the_watchdog():
    timer = tprof.StepTimer(warmup_steps=0)
    for _ in range(3):
        with timer:
            torch.ones(8).sum()
    assert timer.last > 0 and timer.watchdog._step == 3
    assert tprof.StepTimer().watchdog.threshold == jprof.StepTimer().watchdog.threshold == 10.0


def test_span_shows_in_a_cpu_trace_and_profile_to_writes_it(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.span("train_step-7"):
            torch.ones(16).cumsum(0)
    assert [e.name for e in prof.events()].count("train_step-7") == 1

    with tprof.profile_to(str(tmp_path)):
        with tprof.span("train_step-0"):
            torch.ones(16).cumsum(0)
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    events = json.load(open(trace))["traceEvents"]
    assert [e["name"] for e in events if e.get("cat") == "user_annotation"] == ["train_step-0"]

    with tprof.profile_to(None):
        assert not torch.autograd.profiler._is_profiler_enabled
    with tprof.profile_to(""):
        pass


def test_registry_errors_match_and_setup_task_builds_the_port_task(bpe_dir):
    assert treg.TASK_REGISTRY["segmentation"] is TorchTask
    assert TorchTask.task_name == jreg.TASK_REGISTRY["segmentation"].task_name == "segmentation"
    errors = []
    for reg in (jreg, treg):
        with pytest.raises(ValueError) as dup:
            reg.register_task("segmentation")(type("Other", (), {}))
        with pytest.raises(KeyError) as unknown:
            reg.setup_task("no_such_task", None)
        errors.append((str(dup.value), str(unknown.value)))
        assert reg.register_task("segmentation")(reg.TASK_REGISTRY["segmentation"])
    assert errors[0] == errors[1]
    assert errors[1] == ("duplicate task registration: segmentation",
                         "\"unknown task no_such_task; known: ['segmentation']\"")

    cls = treg.register_task("torch_only_test_task")(type("T", (), {
        "setup_task": classmethod(lambda c, cfg: (c, cfg))}))
    try:
        assert cls.task_name == "torch_only_test_task"
        assert treg.setup_task("torch_only_test_task", 3) == (cls, 3)
    finally:
        del treg.TASK_REGISTRY["torch_only_test_task"]

    jcfg, tcfg = JaxConfig(), TorchConfig()
    jcfg.task.bpe_dir = tcfg.task.bpe_dir = bpe_dir
    jtask, ttask = jreg.setup_task("segmentation", jcfg), treg.setup_task("segmentation", tcfg)
    assert isinstance(ttask, TorchTask)
    assert len(ttask.dict) == len(jtask.dict) and ttask.dict.symbols == jtask.dict.symbols


def _feed(bar):
    """The same calls to either package's progress bar."""
    for _ in bar:
        pass
    bar.log({"loss": 1.25, "gnorm": 3, "note": "text", "lr": np.float32(0.5)}, step=7)
    bar.log({"loss": 0.75}, tag="extra")  # no step: the bar's count
    bar.print({"loss": 0.5, "mIoU": 41.0, "sec": 2.5}, tag="valid", step=9)
    bar.print({"ppl": 2 ** 0.5})


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    out = []
    for ev in EventFileLoader(path).Load():
        for v in ev.summary.value:
            value = v.tensor.float_val[0] if v.HasField("tensor") else v.simple_value
            out.append((v.tag, ev.step, value))
    return out


def test_tensorboard_mirrors_write_the_same_scalars(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    _feed(jprogress.progress_bar([1, 2, 3], epoch=1, tag="train", tensorboard_logdir=jdir))
    jprogress._tb_writers.pop(jdir).close()
    bar = tprogress.progress_bar([1, 2, 3], epoch=1, tag="train", tensorboard_logdir=tdir)
    _feed(bar)
    assert tprogress.progress_bar([], tensorboard_logdir=tdir).writer is bar.writer  # one a dir
    want = _scalars(jdir)
    assert _scalars(tdir) == want
    assert ("train/loss", 7, 1.25) in want and ("extra/loss", 3, 0.75) in want
    assert len(want) == 8  # the string is left out

    data = open(bar.writer.path, "rb").read()
    length = struct.unpack("<Q", data[:8])[0]
    assert struct.unpack("<I", data[8:12])[0] == tb_events.masked_crc32c(data[:8])
    assert struct.unpack("<I", data[12 + length:16 + length])[0] == \
        tb_events.masked_crc32c(data[12:12 + length])
    assert tb_events.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_wandb_mirrors_make_the_same_calls(monkeypatch, caplog):
    calls = []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls.append(("init", kw)) or object()
    fake.log = lambda data, step=None: calls.append(("log", data, step))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setenv("WANDB_NAME", "run-7")
    seen = []
    for progress in (jprogress, tprogress):
        calls.clear()
        _feed(progress.progress_bar([1, 2], tag="train", wandb_project="ifseg"))
        seen.append([tuple(map(repr, c)) for c in calls])
    assert seen[0] == seen[1]
    assert calls[0] == ("init", dict(project="ifseg", name="run-7", reinit=False))
    assert calls[1] == ("log", {"loss": 1.25, "gnorm": 3, "lr": np.float32(0.5)}, 7)

    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    warnings = []
    for progress in (jprogress, tprogress):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            bar = progress.progress_bar([1, 2], tag="train", wandb_project="ifseg")
            _feed(bar)
        assert bar.run is None
        warnings.append([r.getMessage() for r in caplog.records])
    assert warnings[0] == warnings[1] == ["wandb unavailable; W&B logging disabled"]


def test_cli_train_spans_and_tensorboard_on_the_cpu(tmp_path, monkeypatch):
    """A CPU rehearsal of chip_smoke.py's phase 19a at the tiny width."""
    import ifseg_torch.cli.train as ttrain
    from ifseg_torch.config import from_flags

    train = make_seg_tsv(str(tmp_path / "train.tsv"), rows=4, seed=11)
    valid = make_seg_tsv(str(tmp_path / "valid.tsv"), rows=2, seed=12)
    tb = str(tmp_path / "tb")
    argv = [f"{train},{valid}", "--arch=segofa_tiny", "--encoder-embed-dim=32",
            "--encoder-ffn-embed-dim=64", "--encoder-layers=2", "--encoder-attention-heads=4",
            "--decoder-embed-dim=32", "--decoder-ffn-embed-dim=64", "--decoder-layers=2",
            "--decoder-attention-heads=4", "--resnet-type=resnet50", "--num-seg-tokens=3",
            "--category-list=cat, dog, grass", "--patch-image-size=32",
            "--orig-patch-image-size=32", "--batch-size=2", "--max-epoch=1",
            "--bpe-dir=assets/BPE", f"--save-dir={tmp_path / 'ckpt'}", "--log-interval=1",
            "--no-save", f"--tensorboard-logdir={tb}"]
    logged = []
    make_bar = ttrain.progress_bar

    def recording_bar(*a, **kw):
        bar = make_bar(*a, **kw)
        inner = bar.bar
        for kind in ("log", "print"):
            def call(stats, tag=None, step=None, _kind=kind, _f=getattr(inner, kind)):
                logged.append((tag or inner.tag or "train", step or inner.i, dict(stats)))
                return _f(stats, tag, step)
            setattr(inner, kind, call)
        return bar

    monkeypatch.setattr(ttrain, "progress_bar", recording_bar)
    with tprof.profile_to(str(tmp_path / "trace")):
        run = ttrain.main(from_flags(argv), device="cpu")
    assert run["num_updates"] == 2
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    spans = [e["name"] for e in json.load(open(trace))["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"].startswith("train_step-")]
    assert spans == ["train_step-0", "train_step-1"]
    want = [(f"{tag}/{k}", step, float(np.float32(v))) for tag, step, stats in logged
            for k, v in stats.items() if isinstance(v, (int, float))]
    assert len(want) > 10 and _scalars(tb) == want
