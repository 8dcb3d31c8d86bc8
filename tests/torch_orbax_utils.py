"""Shared set-up of the tests of ``tools/orbax_to_torch.py``
(tests/test_torch_orbax_*.py): the tool itself, the tiny run's flags, its
JAX parameters, and the port's trainer restored from a converted directory.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ifseg_torch.checkpoint.manager import CheckpointManager as PortManager
from ifseg_torch.config import from_flags as port_flags
from ifseg_torch.train.trainer import Trainer as PortTrainer
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.models.segofa import SegOFAVariables

from torch_port_utils import TINY, class_table, perturb

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import orbax_to_torch as tool  # noqa: E402

NUM_SEG = TINY["num_seg_tokens"]
TOTAL = 20
DIMS = {k: v for k, v in TINY.items() if k not in ("num_seg_tokens",)}


def flags(save_dir, *extra):
    """The tiny run's cli.train flags (everything trains, dropout off, EMA on)."""
    return ["--arch=segofa_tiny", *(f"--{k.replace('_', '-')}={v}" for k, v in DIMS.items()),
            f"--num-seg-tokens={NUM_SEG}", "--dropout=0.0", "--encoder-drop-path-rate=0.0",
            "--decoder-drop-path-rate=0.0", f"--save-dir={save_dir}", "--lr=1e-2",
            "--weight-decay=0.01", "--momentum=0.9", "--warmup-updates=2", "--ema-decay=0.9",
            "--freeze-encoder-embedding=false", "--freeze-decoder-embedding=false",
            "--freeze-seg-embedding=false", *extra]


@pytest.fixture(autouse=True)
def trace_each_model_once(monkeypatch):
    """The tool traces the JAX init for the parameters' shapes; the tests
    convert many runs of one model, so each configuration is traced once."""
    monkeypatch.setattr(tool, "abstract_params", _abstract_params)


_TRACE, _TRACED = tool.abstract_params, {}


def _abstract_params(cfg):
    key = repr((cfg.model, cfg.distributed, cfg.optimization.seed))
    if key not in _TRACED:
        _TRACED[key] = _TRACE(cfg)
    return _TRACED[key]


@functools.lru_cache(maxsize=None)
def tiny_params():
    """The tiny JAX parameters (perturbed), one init for the process."""
    _, tree = SegOFAVariables.init(jax_flags(flags("unused")).model, jax.random.PRNGKey(0))
    return perturb(tree, 0)


def seeded_grads(like, rng, scale=0.1):
    """Seeded gradients shaped like the tree ``like``."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0.0, scale, np.shape(x)).astype(np.float32)), like)


def port_trainer(argv):
    tokens, lengths = class_table(NUM_SEG)
    return PortTrainer(port_flags(argv), tokens, lengths, total_num_updates=TOTAL,
                       device="cpu").init_state()


def restore(trainer, port_dir, name=None):
    """Load checkpoint ``name`` (the newest) of a converted directory into ``trainer``."""
    mgr = PortManager(trainer.cfg.checkpoint, save_dir=port_dir)
    trainer.load_state_dict(mgr.load(name or mgr.latest()))
    return mgr
