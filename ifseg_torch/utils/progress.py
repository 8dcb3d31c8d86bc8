"""Progress logging (fairseq/logging/progress_bar.py's simple and json
formats), a copy of the JAX package's ``utils/progress.py``.

A progress bar wraps a batch iterator; ``log`` emits at intervals, ``print``
emits end-of-epoch stats.  The TensorBoard and W&B mirrors are not ported:
neither package is on the card's machine, and a ``tensorboard_logdir`` or
``wandb_project`` raises (ROADMAP.md A.10).
"""

import json
import logging
from numbers import Number
from typing import Any, Dict, Iterable, Optional

logger = logging.getLogger(__name__)


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
    if tensorboard_logdir or wandb_project:
        raise NotImplementedError(
            "the TensorBoard and W&B mirrors of the progress bar are not ported "
            "(ROADMAP.md A.10): drop --tensorboard-logdir and --wandb-project")
    cls = JsonProgressBar if log_format == "json" else SimpleProgressBar
    return cls(iterator, total, epoch, log_interval, tag)


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
