"""Metrics aggregation: meters, derived metrics, hierarchical contexts.

Capability parity with custom_fairseq/fairseq/logging/{meters,metrics}.py:
AverageMeter (:66), SumMeter incl. tensor-valued sums (:112; what makes
vectorized per-class IoU accumulation work), TimeMeter, StopwatchMeter,
``aggregate()`` nested contexts (metrics.py:45), ``log_scalar``/
``log_scalar_sum``/``log_derived`` (:111-171), ``state_dict`` (:299).

A copy of the JAX package's ``utils/metrics.py``.  Meters hold numpy
values; a torch tensor is read back to the host when it is logged.
``cross_process_sum`` sums a logging dict over the processes of a
``torch.distributed`` group (the identity on one process).

The segmentation deriveds (seg_criterion.py:552-572): aAcc = Σintersect/Σpred,
mIoU = nanmean(intersect/union), mAcc = nanmean(intersect/label).
"""

import contextlib
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


class Meter:
    def reset(self):
        raise NotImplementedError

    @property
    def smoothed_value(self):
        raise NotImplementedError

    def state_dict(self):
        return self.__dict__.copy()

    def load_state_dict(self, d):
        self.__dict__.update(d)


class AverageMeter(Meter):
    """Weighted running average (meters.py:66)."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self):
        self.val = None
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        if val is None:
            return
        val = _to_numpy(val)
        self.val = val
        if n > 0:
            self.sum = self.sum + val * n
            self.count = self.count + n

    @property
    def avg(self):
        return self.sum / self.count if self.count > 0 else self.val

    @property
    def smoothed_value(self):
        v = self.avg
        if self.round is not None and v is not None:
            v = safe_round(v, self.round)
        return v


class SumMeter(Meter):
    """Running sum; supports array values (meters.py:112)."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self):
        self.sum = 0

    def update(self, val):
        if val is not None:
            self.sum = self.sum + _to_numpy(val)

    @property
    def smoothed_value(self):
        v = self.sum
        if self.round is not None and np.ndim(v) == 0:
            v = safe_round(v, self.round)
        return v


class TimeMeter(Meter):
    """Average rate (items/sec) since init (meters.py:159)."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self, init=0, n=0):
        self.init = init
        self.start = time.perf_counter()
        self.n = n

    def update(self, val=1):
        self.n += val

    @property
    def avg(self):
        elapsed = self.init + (time.perf_counter() - self.start)
        return self.n / elapsed if elapsed > 0 else 0.0

    @property
    def smoothed_value(self):
        v = self.avg
        return safe_round(v, self.round) if self.round is not None else v


class StopwatchMeter(Meter):
    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.sum = 0.0
        self.n = 0
        self.start_time = None

    def reset(self):
        self.sum = 0.0
        self.n = 0
        self.start_time = None

    def start(self):
        self.start_time = time.perf_counter()

    def stop(self, n=1):
        if self.start_time is not None:
            self.sum += time.perf_counter() - self.start_time
            self.n += n
            self.start_time = None

    @property
    def avg(self):
        return self.sum / self.n if self.n > 0 else self.sum

    @property
    def smoothed_value(self):
        v = self.avg
        return safe_round(v, self.round) if self.round is not None else v


def safe_round(number, ndigits):
    if hasattr(number, "item"):
        number = number.item()
    if isinstance(number, float) or isinstance(number, int):
        return round(number, ndigits)
    return number


class MetersDict(OrderedDict):
    """Meters with priorities + derived metrics (metrics.py:180-260)."""

    class _DerivedMeter(Meter):
        def __init__(self, fn):
            self.fn = fn

        def reset(self):
            pass

        @property
        def smoothed_value(self):
            return self.fn(self._parent)

    def __init__(self):
        super().__init__()
        self.priorities = []

    def add_meter(self, key, meter, priority=50):
        if key in self:
            return
        self.priorities.append((priority, len(self.priorities), key))
        self.priorities.sort()
        self[key] = meter
        if isinstance(meter, MetersDict._DerivedMeter):
            meter._parent = self

    def get_smoothed_values(self) -> Dict[str, Any]:
        out = OrderedDict()
        for _, _, key in self.priorities:
            if key.startswith("_"):
                continue
            v = self[key].smoothed_value
            out[key] = v
        return out

    def reset(self):
        for m in self.values():
            m.reset()

    def state_dict(self):
        return [
            (key, (type(m).__name__, m.state_dict()))
            for (_, _, key) in self.priorities
            for m in [self[key]]
            if not isinstance(m, MetersDict._DerivedMeter)
        ]

    def load_state_dict(self, state):
        self.clear()
        self.priorities.clear()
        for key, (cls_name, md) in state:
            m = {
                "AverageMeter": AverageMeter,
                "SumMeter": SumMeter,
                "TimeMeter": TimeMeter,
                "StopwatchMeter": StopwatchMeter,
            }[cls_name]()
            m.load_state_dict(md)
            self.add_meter(key, m)


# ------------------------------------------------------------- global registry

_aggregators: "OrderedDict[str, MetersDict]" = OrderedDict()
_active: Dict[str, MetersDict] = {}


def reset() -> None:
    """Drop every aggregator and its meters (fairseq's metrics.reset): a
    training run starts from an empty registry, whatever ran before it in
    the process."""
    _aggregators.clear()
    _active.clear()
    _default()


def _default():
    if "default" not in _aggregators:
        _aggregators["default"] = MetersDict()
        _active["default"] = _aggregators["default"]
    return _aggregators["default"]


_default()


@contextlib.contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Nested aggregation context (metrics.py:45-108)."""
    if name is None:
        name = f"anon_{len(_aggregators)}"
    agg = _aggregators.setdefault(name, MetersDict())
    if new_root:
        backup = dict(_active)
        _active.clear()
    _active[name] = agg
    try:
        yield agg
    finally:
        _active.pop(name, None)
        if new_root:
            _active.update(backup)


def _all_active() -> List[MetersDict]:
    return list(_active.values()) or [_default()]


def log_scalar(key, value, weight=1, priority=50, round=None):
    for agg in _all_active():
        agg.add_meter(key, AverageMeter(round=round), priority)
        agg[key].update(value, weight)


def log_scalar_sum(key, value, priority=50, round=None):
    """Accumulate a (possibly tensor-valued) sum (metrics.py:133)."""
    for agg in _all_active():
        agg.add_meter(key, SumMeter(round=round), priority)
        agg[key].update(value)


def log_derived(key, fn: Callable, priority=50):
    for agg in _all_active():
        agg.add_meter(key, MetersDict._DerivedMeter(fn), priority)


def log_speed(key, value, priority=50, round=None):
    for agg in _all_active():
        agg.add_meter(key, TimeMeter(round=round), priority)
        agg[key].update(value)


def get_meter(name: str, key: str) -> Optional[Meter]:
    agg = _aggregators.get(name)
    return agg.get(key) if agg else None


def get_smoothed_values(name: str) -> Dict[str, Any]:
    return _aggregators[name].get_smoothed_values() if name in _aggregators else {}


def reset_meters(name: str) -> None:
    if name in _aggregators:
        _aggregators[name].reset()


def state_dict():
    return {name: agg.state_dict() for name, agg in _aggregators.items()}


def load_state_dict(state):
    for name, agg_state in state.items():
        _aggregators.setdefault(name, MetersDict()).load_state_dict(agg_state)


def cross_process_sum(logging_output: Dict[str, Any], group=None,
                      device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Sum a logging dict across the processes of ``group`` (the world by
    default; the reference's fast-stat-sync path, trainer.py:1368-1407 /
    all_reduce_dict): every numeric entry (a number or an array) becomes
    its sum over the processes, as a numpy value; other entries pass as
    they are.  One all-reduce of the entries flattened in key order, in
    fp64, on ``device`` (the CPU by default; a NCCL group needs its card).
    One process: the identity."""
    if not (torch.distributed.is_available() and torch.distributed.is_initialized()) \
            or torch.distributed.get_world_size(group) == 1:
        return logging_output
    keys = [k for k in sorted(logging_output)
            if isinstance(logging_output[k], (int, float, np.ndarray, np.number, torch.Tensor))]
    values = [np.asarray(_to_numpy(logging_output[k]), dtype=np.float64) for k in keys]
    flat = torch.from_numpy(np.concatenate([v.reshape(-1) for v in values]) if values
                            else np.zeros(0)).to(device or "cpu")
    torch.distributed.all_reduce(flat, group=group)
    flat = flat.cpu().numpy()
    out = dict(logging_output)
    offset = 0
    for k, v in zip(keys, values):
        out[k] = flat[offset:offset + v.size].reshape(v.shape)
        offset += v.size
    return out


# ----------------------------------------------------- segmentation deriveds


def nanmean(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.nanmean(x))


def register_seg_metrics(suffix: str = "") -> None:
    """aAcc/mIoU/mAcc derived from per-class area SumMeters
    (seg_criterion.py:533-572).  ``suffix`` distinguishes the lowres /
    resnet_postprocess variants (:451-531)."""
    s = f"_{suffix}" if suffix else ""

    def aacc(meters):
        inter = np.sum(meters[f"_area_intersect{s}"].sum)
        pred = np.sum(meters[f"_area_pred_label{s}"].sum)
        return safe_round(inter / pred if pred > 0 else float("nan"), 4)

    def miou(meters):
        with np.errstate(invalid="ignore", divide="ignore"):
            r = meters[f"_area_intersect{s}"].sum / meters[f"_area_union{s}"].sum
        return safe_round(nanmean(r), 4)

    def macc(meters):
        with np.errstate(invalid="ignore", divide="ignore"):
            r = meters[f"_area_intersect{s}"].sum / meters[f"_area_label{s}"].sum
        return safe_round(nanmean(r), 4)

    log_derived(f"aAcc{s}", aacc)
    log_derived(f"mIoU{s}", miou)
    log_derived(f"mAcc{s}", macc)


def log_seg_areas(areas, suffix: str = "") -> None:
    """areas = (intersect, pred, label, union) per-class arrays."""
    s = f"_{suffix}" if suffix else ""
    intersect, pred, label, union = areas
    log_scalar_sum(f"_area_intersect{s}", intersect)
    log_scalar_sum(f"_area_pred_label{s}", pred)
    log_scalar_sum(f"_area_label{s}", label)
    log_scalar_sum(f"_area_union{s}", union)
    register_seg_metrics(suffix)
