"""Progress logging (fairseq/logging/progress_bar.py's simple and json
formats), a copy of the JAX package's ``utils/progress.py``.

A progress bar wraps a batch iterator; ``log`` emits at intervals, ``print``
emits end-of-epoch stats.  ``tensorboard_logdir`` adds the TensorBoard
mirror: each numeric stat as the scalar ``<tag>/<name>`` at ``step`` (the
bar's count when none is given), one writer a log dir, written by the
port's own event writer (``utils/tb_events.py``: the JAX package's
``tensorboardX`` is not on the card's machine).  ``wandb_project`` adds the
W&B mirror, as the JAX package's: ``wandb.init`` with the run name of
``$WANDB_NAME`` and ``wandb.log`` of the numeric stats; without the
``wandb`` package it logs the JAX package's warning and mirrors nothing.
"""

import json
import logging
import os
from numbers import Number
from typing import Any, Dict, Iterable, Optional

from ifseg_torch.utils.tb_events import EventFileWriter

logger = logging.getLogger(__name__)

_tb_writers: Dict[str, Any] = {}


def progress_bar(
    iterator: Iterable,
    total: Optional[int] = None,
    epoch: Optional[int] = None,
    log_interval: int = 100,
    log_format: str = "simple",
    tag: str = "",
    tensorboard_logdir: Optional[str] = None,
    wandb_project: Optional[str] = None,
):
    if log_format == "json":
        bar = JsonProgressBar(iterator, total, epoch, log_interval, tag)
    else:
        bar = SimpleProgressBar(iterator, total, epoch, log_interval, tag)
    if tensorboard_logdir:
        bar = TensorboardWrapper(bar, tensorboard_logdir)
    if wandb_project:
        bar = WandbWrapper(bar, wandb_project)
    return bar


def _fmt_stats(stats: Dict[str, Any]) -> str:
    def one(v):
        if isinstance(v, Number):
            return f"{v:.4g}" if isinstance(v, float) else str(v)
        return str(v)

    return " | ".join(f"{k} {one(v)}" for k, v in stats.items())


class BaseProgressBar:
    def __init__(self, iterator, total=None, epoch=None, log_interval=100, tag=""):
        self.iterator = iterator
        self.total = total
        self.epoch = epoch
        self.log_interval = log_interval
        self.tag = tag
        self.i = 0

    def __iter__(self):
        for obj in self.iterator:
            self.i += 1
            yield obj

    def log(self, stats: Dict[str, Any], tag=None, step=None):
        raise NotImplementedError

    def print(self, stats: Dict[str, Any], tag=None, step=None):
        raise NotImplementedError


class SimpleProgressBar(BaseProgressBar):
    def log(self, stats, tag=None, step=None):
        prefix = f"epoch {self.epoch:03d}: " if self.epoch is not None else ""
        pos = f"{self.i}/{self.total}" if self.total else str(self.i)
        logger.info("%s%s %s", prefix, pos, _fmt_stats(stats))

    def print(self, stats, tag=None, step=None):
        tag = tag or self.tag
        prefix = f"epoch {self.epoch:03d}" if self.epoch is not None else tag
        logger.info("%s | %s | %s", tag, prefix, _fmt_stats(stats))


class JsonProgressBar(BaseProgressBar):
    def _emit(self, stats, step):
        payload = dict(stats)
        if self.epoch is not None:
            payload["epoch"] = self.epoch
        if step is not None:
            payload["num_updates"] = step
        print(json.dumps(payload, default=str), flush=True)

    def log(self, stats, tag=None, step=None):
        self._emit(stats, step)

    def print(self, stats, tag=None, step=None):
        self._emit(stats, step)


class TensorboardWrapper:
    def __init__(self, bar: BaseProgressBar, logdir: str):
        self.bar = bar
        if logdir not in _tb_writers:
            _tb_writers[logdir] = EventFileWriter(logdir)
        self.writer = _tb_writers[logdir]

    def __iter__(self):
        return iter(self.bar)

    def _write(self, stats, tag, step):
        tag = tag or self.bar.tag or "train"
        for k, v in stats.items():
            if isinstance(v, Number):
                self.writer.add_scalar(f"{tag}/{k}", float(v), step or self.bar.i)

    def log(self, stats, tag=None, step=None):
        self._write(stats, tag, step)
        self.bar.log(stats, tag, step)

    def print(self, stats, tag=None, step=None):
        self._write(stats, tag, step)
        self.bar.print(stats, tag, step)


class WandbWrapper:
    def __init__(self, bar: BaseProgressBar, project: str):
        self.bar = bar
        self.run = None
        try:
            import wandb

            self.run = wandb.init(
                project=project, name=os.environ.get("WANDB_NAME"), reinit=False
            )
        except Exception:  # no package, no login: the run goes on unmirrored, as in JAX
            logger.warning("wandb unavailable; W&B logging disabled")

    def __iter__(self):
        return iter(self.bar)

    def _write(self, stats, step):
        if self.run is None:
            return
        import wandb

        wandb.log({k: v for k, v in stats.items() if isinstance(v, Number)}, step=step)

    def log(self, stats, tag=None, step=None):
        self._write(stats, step)
        self.bar.log(stats, tag, step)

    def print(self, stats, tag=None, step=None):
        self._write(stats, step)
        self.bar.print(stats, tag, step)
