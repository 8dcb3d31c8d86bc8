"""Tracing and step-time watchdog, the counterpart of the JAX package's
``utils/profiling.py`` (reference train.py:312-314 ``record_function``
spans, :530-533 the profiler, trainer.py:1490-1505 the compile watchdog).

  - ``span(name)``: a named range that shows in ``torch.profiler``'s trace
    (``record_function``) and, with a card, in Nsight Systems (an NVTX
    range);
  - ``profile_to(logdir)``: a ``torch.profiler`` trace of the block written
    to ``logdir`` as a Chrome trace by torch's own
    ``tensorboard_trace_handler`` (no tensorboard package needed), which
    TensorBoard's profiler plugin and Perfetto read; nothing for None;
  - ``CompilationWatchdog`` / ``StepTimer``: the JAX package's rule and
    defaults (after 3 warm-up steps, a step slower than 10 x the median of
    the last 50, once 5 are known, is flagged).  Eager PyTorch compiles no
    programs, so a flagged step is a stall (the host pipeline, a
    synchronisation, another process on the card), not a recompilation.

The JAX package's ``enable_persistent_jit_cache`` has no counterpart: the
port compiles no programs, and its kernels are built once by ``nvcc`` into
``ifseg_torch/_build/`` and reused (``ops/build.py``).
"""

import contextlib
import logging
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def span(name: str):
    """A named span in the profiler's trace and, with a card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_to(logdir: Optional[str]):
    """Trace the enclosed block with ``torch.profiler`` (the CPU, and the
    card when there is one) into a Chrome trace under ``logdir``; a no-op
    for None or an empty string."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
    logger.info("profiler trace written to %s", logdir)


class CompilationWatchdog:
    """Flag a step far slower than the recent ones (the JAX package's
    recompile watchdog, reference trainer.py:1490-1505): after ``warmup_steps``,
    a step above ``threshold`` x the median of the last 50 (once 5 are
    known).  In eager PyTorch nothing recompiles, so it reads a stall."""

    def __init__(self, warmup_steps: int = 3, threshold: float = 10.0):
        self.warmup = warmup_steps
        self.threshold = threshold
        self._times = []
        self._step = 0
        self._warned = 0

    def step(self, duration_s: float) -> bool:
        """Record a step's duration; True if it is flagged."""
        self._step += 1
        if self._step <= self.warmup:
            return False
        self._times.append(duration_s)
        if len(self._times) < 5:
            return False
        recent = self._times[-50:]
        med = sorted(recent)[len(recent) // 2]
        if duration_s > self.threshold * max(med, 1e-6):
            self._warned += 1
            logger.warning(
                "step %d took %.2fs (median %.3fs): a stall (eager PyTorch does not "
                "recompile); check the input pipeline, host reads of the card and other "
                "processes on it", self._step, duration_s, med)
            return True
        return False


class StepTimer:
    """Each step's wall time (``last``), fed to a ``CompilationWatchdog``; a
    context manager around the step."""

    def __init__(self, **watchdog_kwargs):
        self.watchdog = CompilationWatchdog(**watchdog_kwargs)
        self._t0 = None
        self.last = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        self.watchdog.step(self.last)
        return False
