"""``ifseg_torch.cli.train`` and ``cli.validate`` on two processes, on the CPU.

The CLIs run as two subprocesses (``--num-processes=2 --process-id={0,1}``)
that meet at a ``file://`` coordinator address in ``tmp_path`` (no TCP
port, so parallel test workers never race for one), with the tiny widths
and dropout off:

- ``cli.train --fsdp=2 --max-update=2``: both ranks stop after the same
  update (ROADMAP.md C.5) with the same reason, validate once, and only rank
  0 writes checkpoint files and the TensorBoard event file; the
  parameter-sync and grad-norm sanitizers run at every log;
- the saved state is the whole one: a one-process trainer restores it and
  hands back exactly what was saved;
- ``cli.validate`` on that checkpoint over 2 processes (each its slice of
  the rows) gives the one-process areas and mIoU exactly;
- ``cli.train --pipeline-parallel=2`` on two processes stopped at
  ``--max-update=1`` and resumed to 2 stops, resumes and saves as one
  process does with the same flags (without the pipeline): the same
  updates, stops and saves, and the last checkpoint's weights within 1e-6
  of the one-process run's over the whole model.  Tensor by tensor they
  differ by no more than the two Adam steps can move a tensor (2 · lr a
  entry): a key bias, whose gradient is zero up to rounding, takes ±lr
  from the sign of that noise, which the pipeline's sums round otherwise.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from utils import make_seg_tsv
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
            encoder_attention_heads=4, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_layers=2, decoder_attention_heads=4, resnet_type="resnet50")

# run the CLI's main, record which checkpoint states this process wrote,
# and leave its summary as JSON
CLI_RUNNER = r"""
import json, sys
from ifseg_torch.checkpoint import manager
from ifseg_torch.config import from_flags
writes = []
write_state = manager.CheckpointManager._write_state
def recorded(self, name, state):
    writes.append(name)
    return write_state(self, name, state)
manager.CheckpointManager._write_state = recorded
kind, argv, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
if kind == "train":
    from ifseg_torch.cli import train
    run = train.main(from_flags(argv), device="cpu")
    summary = dict(num_updates=run["num_updates"], stop=run["stop"], saves=[s["name"] for s in run["saves"]],
                   valid=[e["valid"] for e in run["epochs"]])
else:
    from ifseg_torch.cli import validate
    logs = []
    vals = validate.main(from_flags(argv), device="cpu", logs_out=logs)
    summary = dict(vals=vals, areas={k: logs[0][k].tolist() for k in logs[0] if k.startswith("area")})
summary["writes"] = writes
json.dump(summary, open(out, "w"), default=float)
"""


def _argv(data, save_dir, *extra):
    return [data, "--arch=segofa_tiny", *(f"--{k.replace('_', '-')}={v}" for k, v in DIMS.items()),
            "--num-seg-tokens=3", "--category-list=cat, dog, grass", "--patch-image-size=64",
            "--orig-patch-image-size=64", "--bpe-dir=assets/BPE", f"--save-dir={save_dir}",
            "--batch-size=2", "--batch-size-valid=2", "--lr=1e-3", "--log-interval=1",
            "--dtype=float32", "--dropout=0.0", "--encoder-drop-path-rate=0.0",
            "--decoder-drop-path-rate=0.0", *extra]


def _run_two(kind, argv, tmp_path, tag):
    env = dict(os.environ, PYTHONPATH=REPO, IFSEG_HEARTBEAT="120", OMP_NUM_THREADS="1")
    rdv = f"file://{tmp_path}/rdv-{tag}"
    procs, outs = [], []
    for rank in range(2):
        out = str(tmp_path / f"{tag}-{rank}.json")
        flags = argv + ["--num-processes=2", f"--process-id={rank}",
                        f"--coordinator-address={rdv}"]
        procs.append(subprocess.Popen([sys.executable, "-c", CLI_RUNNER, kind, json.dumps(flags), out],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [json.load(open(o)) for o in outs]


@pytest.fixture(scope="module")
def trained(request, tmp_path_factory):
    """The two-process run; its directory is removed after the module when
    the module's tests passed."""
    tmp = tmp_path_factory.mktemp("cli")
    failed = request.session.testsfailed
    train = make_seg_tsv(str(tmp / "train.tsv"), rows=8, num_seg=3, size=(64, 64), seed=1)
    valid = make_seg_tsv(str(tmp / "valid.tsv"), rows=6, num_seg=3, size=(80, 96), seed=2)
    data = f"{train},{valid}"
    save_dir = tmp / "ckpt"
    argv = _argv(data, save_dir, "--fsdp=2", "--max-epoch=2", "--max-update=2",
                 "--check-param-sync-interval=1", f"--tensorboard-logdir={tmp / 'tb'}")
    yield dict(tmp=tmp, data=data, valid=valid, save_dir=save_dir, argv=argv,
               runs=_run_two("train", argv, tmp, "train"))
    if request.session.testsfailed == failed:
        shutil.rmtree(tmp, ignore_errors=True)


def test_both_ranks_stop_after_the_same_update(trained):
    a, b = trained["runs"]
    assert a["num_updates"] == b["num_updates"] == 2
    assert a["stop"] == b["stop"] and "max_update 2" in a["stop"]
    assert a["valid"] == b["valid"] and a["valid"][0]["num_images"] == 6


def test_rank_0_alone_writes_the_checkpoint(trained):
    a, b = trained["runs"]
    assert a["writes"] == a["saves"] != [] and b["writes"] == []
    assert sorted(os.listdir(trained["save_dir"] / a["saves"][-1])) == [
        "generator.pt", "model.pt", "optimizer.pt", "step.pt"]


def test_rank_0_alone_writes_the_tensorboard_events(trained):
    """One event file for the run, each (tag, step) in it once: the other
    rank writes none."""
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    files = os.listdir(trained["tmp"] / "tb")
    assert len(files) == 1 and files[0].startswith("events.out.tfevents."), files
    pairs = [(v.tag, e.step) for e in EventFileLoader(str(trained["tmp"] / "tb" / files[0])).Load()
             for v in e.summary.value]
    assert len(pairs) == len(set(pairs)) and ("train/loss", 1) in pairs, pairs


def test_one_process_resume_restores_what_was_saved(trained):
    from ifseg_torch.checkpoint.manager import CheckpointManager
    from ifseg_torch.config import from_flags
    from ifseg_torch.train.trainer import Trainer

    cfg = from_flags(_argv(trained["data"], trained["save_dir"]))
    ckpt = CheckpointManager(cfg.checkpoint)
    saved = ckpt.load(ckpt.latest())
    trainer = Trainer(cfg, device="cpu").init_state()
    trainer.load_state_dict(saved)
    again = trainer.state_dict()
    assert again["step"] == saved["step"] == 2
    for part in ("model", "optimizer"):
        flat_a = {k: v for k, v in _flat(again[part])}
        flat_s = {k: v for k, v in _flat(saved[part])}
        assert flat_a.keys() == flat_s.keys()
        for k, v in flat_s.items():
            assert torch.equal(flat_a[k], v) if torch.is_tensor(v) else flat_a[k] == v, k


def _flat(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix, node


def test_validate_on_two_processes_equals_one_process(trained):
    from ifseg_torch.cli import validate
    from ifseg_torch.config import from_flags
    from ifseg_torch.utils import metrics

    # the meters are process-wide: a validation with label propagation run
    # earlier in this process (another test file) leaves its derived
    # meters registered, which this run without it would read at zero
    metrics.reset()
    best = str(trained["save_dir"] / "checkpoint_last")
    argv = _argv(trained["valid"], trained["save_dir"], f"--restore-file={best}")
    logs = []
    one = validate.main(from_flags(argv), device="cpu", logs_out=logs)
    areas = {k: sum(np.asarray(lg[k], np.float64) for lg in logs) for k in logs[0]
             if k.startswith("area")}
    two = _run_two("validate", argv, trained["tmp"], "validate")
    for run in two:
        assert run["vals"]["num_images"] == one["num_images"] == 6
        assert run["vals"]["mIoU"] == one["mIoU"]
        for k, v in areas.items():
            np.testing.assert_array_equal(run["areas"][k], v)


@pytest.fixture(scope="module")
def pipelined(trained):
    from ifseg_torch.cli import train
    from ifseg_torch.config import from_flags

    runs = {}
    for tag in ("two", "one"):
        save = trained["tmp"] / f"pp-{tag}"
        out = []
        for stop in (1, 2):
            argv = _argv(trained["data"], save, "--max-epoch=1", f"--max-update={stop}")
            if tag == "two":
                out.append(_run_two("train", argv + ["--pipeline-parallel=2"], trained["tmp"],
                                    f"pp{stop}")[0])
            else:
                run = train.main(from_flags(argv), device="cpu")
                out.append(dict(num_updates=run["num_updates"], stop=run["stop"],
                                saves=[x["name"] for x in run["saves"]]))
        runs[tag] = dict(runs=out, last=torch.load(save / out[-1]["saves"][-1] / "model.pt"))
    return runs


def test_pipeline_cli_stops_and_resumes_as_one_process(pipelined):
    two, one = pipelined["two"], pipelined["one"]
    for a, b in zip(two["runs"], one["runs"]):
        assert a["num_updates"] == b["num_updates"] and a["stop"] == b["stop"]
        assert a["saves"] == b["saves"]
    assert two["runs"][-1]["num_updates"] == 2
    assert two["last"].keys() == one["last"].keys()
    keys = [k for k, v in one["last"].items() if v.is_floating_point()]
    flat = lambda sd: torch.cat([sd[k].double().reshape(-1) for k in keys])
    assert float((flat(two["last"]) - flat(one["last"])).norm()) <= 1e-6 * float(
        flat(one["last"]).norm())
    for k in keys:
        assert float((two["last"][k].double() - one["last"][k].double()).abs().max()) <= 2e-3, k
