"""Failure detection across processes (the JAX package's
``utils/reliability.py``, SURVEY.md §5).

  - ``global_grad_norm``: the norm over every gradient, a part of a split
    tensor counted once (the reference's grad-norm sanitizer reads it);
  - ``check_grad_norms``: every rank's gradient norm gathered and compared
    within a tolerance, the replica-desync detector (trainer.py:1408-1445);
  - ``param_fingerprint`` / ``check_param_sync``: Σ (i+1)·Σp² over the
    parameters in the JAX tree's order, compared across ranks (catches
    replicas that drifted after a restore or a flaky collective);
  - ``Heartbeat``: a watchdog thread that logs (and optionally interrupts)
    when the train loop stops making progress
    (distributed/distributed_timeout_wrapper.py:17-94);
  - ``nan_debug``: PyTorch's anomaly mode with NaN checks, which raises at
    the operation whose backward produced a NaN (the counterpart of the JAX
    package's ``jax_debug_nans``; the trainer's skip of a non-finite update
    handles recovery, this is for debugging).

A parameter split across ranks (TP, FSDP) enters by its part, with the part
groups of ``train/optim.py``'s ``Sharding``: its partial sums are summed over
them, so the fingerprint and the norm are those of the whole tensors, and a
part that drifted on one rank changes that rank's result.
"""

import contextlib
import logging
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ifseg_torch.parallel import comm
from ifseg_torch.train.optim import Sharding, sum_over_parts

logger = logging.getLogger(__name__)


def global_grad_norm(grads: Sequence[torch.Tensor],
                     sharding: Optional[Sharding] = None) -> torch.Tensor:
    """sqrt(Σ Σ g²) over ``grads``, in fp32."""
    sq = [g.float().square().sum() for g in grads]
    if sharding is not None:
        sq = sum_over_parts(sq, [sharding.groups(i) for i in range(len(sq))])
    total = torch.zeros((), dtype=torch.float32, device=sq[0].device if sq else "cpu")
    for s in sq:
        total = total + s
    return total.sqrt()


def _all_gather_value(value: float, group, device) -> np.ndarray:
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    return comm.all_gather_scalars(t, group).reshape(-1).cpu().numpy()


def check_grad_norms(local_norm: float, tolerance: float = 1e-4, group=None,
                     device="cpu") -> bool:
    """Gather every rank's gradient norm over ``group`` (the world by
    default) and check them within ``tolerance`` of rank 0's, relative
    (trainer.py:1408-1445).  One process: True."""
    if not _distributed():
        return True
    norms = _all_gather_value(local_norm, group or torch.distributed.group.WORLD, device)
    ref = norms[0]
    ok = bool(np.all(np.abs(norms - ref) <= tolerance * max(abs(ref), 1e-6)))
    if not ok:
        logger.error("grad norms inconsistent across ranks: %s — replicas desynced "
                     "(bad data sharding or collective failure)", norms.tolist())
    return ok


def param_fingerprint(params: Dict[str, torch.Tensor], sharding: Optional[Sharding] = None,
                      order: Optional[List[str]] = None) -> float:
    """Σ (i+1)·Σp² over ``params`` in fp32, i running over the keys in the
    order of the JAX tree's leaves (the '/'-joined paths sorted part by
    part; ``order`` gives another).  ``sharding`` (aligned with that order)
    says which tensors are parts of larger ones."""
    keys = order or sorted(params, key=lambda k: k.split("/"))
    sq = [params[k].float().square().sum() for k in keys]
    if sharding is not None:
        sq = sum_over_parts(sq, [sharding.groups(i) for i in range(len(sq))])
    acc = torch.zeros((), dtype=torch.float32, device=sq[0].device if sq else "cpu")
    for i, s in enumerate(sq):
        acc = acc + (i + 1) * s
    return float(acc)


def check_param_sync(fingerprint: float, tolerance: float = 1e-5, group=None,
                     device="cpu") -> bool:
    """Gather every rank's ``param_fingerprint`` and check them within
    ``tolerance`` of rank 0's, relative.  One process: True."""
    if not _distributed():
        return True
    fps = _all_gather_value(fingerprint, group or torch.distributed.group.WORLD, device)
    ok = bool(np.all(np.abs(fps - fps[0]) <= tolerance * max(abs(fps[0]), 1e-6)))
    if not ok:
        logger.error("parameter fingerprints differ across ranks: %s", fps.tolist())
    return ok


def _distributed() -> bool:
    return (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


class Heartbeat:
    """Log (and with ``kill`` interrupt the process) when no ``beat`` came
    within ``timeout`` seconds (DistributedTimeoutWrapper analog)."""

    def __init__(self, timeout: float, kill: bool = False):
        self.timeout = timeout
        self.kill = kill
        self.fired = 0
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self):
        self._last = time.monotonic()

    def start(self):
        if self.timeout <= 0:
            return self

        def watch():
            while not self._stop.wait(min(self.timeout / 4, 30.0)):
                stalled = time.monotonic() - self._last
                if stalled > self.timeout:
                    self.fired += 1
                    logger.error("no training progress for %.0fs (timeout %.0fs)",
                                 stalled, self.timeout)
                    if self.kill:
                        os.kill(os.getpid(), signal.SIGINT)
                    self._last = time.monotonic()  # don't spam

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Anomaly detection with NaN checks for the block: an error at the
    operation whose backward produced a NaN."""
    if not enable:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
