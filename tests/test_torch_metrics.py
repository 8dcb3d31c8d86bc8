"""The port's meters and the task's metric reduction against the JAX
package's: the same logging dicts give the same smoothed values (mIoU, aAcc,
mAcc and their label-propagation variants, the count-weighted loss), the
port also taking torch tensors where the JAX package takes numpy.
"""

import numpy as np
import pytest
import torch

from ifseg_torch.tasks.segmentation import SegmentationTask as TorchTask
from ifseg_torch.utils import metrics as tm
from ifseg_tpu.tasks.segmentation import SegmentationTask as JaxTask
from ifseg_tpu.utils import metrics as jm
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

AREAS = ("area_intersect", "area_pred_label", "area_label", "area_union")


def _eval_logs(seed, groups=3, classes=6):
    """Logs of evaluation groups: per-class areas (class 4 never present,
    so its IoU is 0/0), the summable (nll_sum, nll_cnt) and the per-group
    ratios."""
    rng = np.random.default_rng(seed)
    logs = []
    for _ in range(groups):
        label = rng.integers(0, 500, classes).astype(np.float32)
        label[4] = 0
        pred = rng.integers(0, 500, classes).astype(np.float32)
        pred[4] = 0
        inter = np.minimum(label, pred) * rng.uniform(0.2, 1.0, classes).astype(np.float32)
        inter = np.floor(inter)
        log = {}
        for suffix in ("", "_resnet_postprocess"):
            log.update({f"area_intersect{suffix}": inter, f"area_pred_label{suffix}": pred,
                        f"area_label{suffix}": label,
                        f"area_union{suffix}": label + pred - inter})
        cnt = np.float32(label.sum())
        log.update(nll_sum=np.float32(rng.uniform(1, 3) * cnt), nll_cnt=cnt)
        log["nll_loss"] = log["loss"] = log["nll_sum"] / cnt
        logs.append(log)
    return logs


def _reduce(task, lib, logs, name="validate"):
    lib.reset_meters(name)
    with lib.aggregate(name, new_root=True) as agg:
        task.reduce_metrics(logs)
        return agg.get_smoothed_values()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_reduction_equals_jax(seed):
    logs = _eval_logs(seed)
    want = _reduce(JaxTask, jm, logs)
    got = _reduce(TorchTask, tm, logs)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert {"mIoU", "aAcc", "mAcc", "mIoU_resnet_postprocess", "loss", "nll_loss"} <= set(got)
    # torch tensors (what the evaluator returns before its read-back) give the same
    tlogs = [{k: torch.as_tensor(v) for k, v in log.items()} for log in logs]
    assert _reduce(TorchTask, tm, tlogs) == got
    for k in AREAS:
        np.testing.assert_array_equal(tm.get_meter("validate", f"_{k}").sum,
                                      jm.get_meter("validate", f"_{k}").sum)


def test_training_style_logs_equal_jax():
    rng = np.random.default_rng(3)
    logs = [dict(loss=np.float32(rng.uniform(1, 2)), nll_loss=np.float32(rng.uniform(1, 2)),
                 gnorm=np.float32(rng.uniform(0, 5)), n_nonfinite=np.int32(i % 2))
            for i in range(4)]
    assert _reduce(TorchTask, tm, logs, "train") == _reduce(JaxTask, jm, logs, "train")


def test_meters_equal_jax():
    assert tm.safe_round(torch.tensor(1.23456), 3) == jm.safe_round(np.float32(1.23456), 3)
    got, want = tm.AverageMeter(round=4), jm.AverageMeter(round=4)
    for v, n in ((1.5, 2), (torch.tensor(2.25), 3), (0.5, 0)):
        got.update(v, n)
        want.update(float(v), n)
    assert got.smoothed_value == want.smoothed_value
    s_got, s_want = tm.SumMeter(), jm.SumMeter()
    for v in (np.arange(3.0), np.ones(3)):
        s_got.update(torch.from_numpy(v))
        s_want.update(v)
    np.testing.assert_array_equal(s_got.smoothed_value, s_want.smoothed_value)
    # the meters' state dicts hold the same entries, and restore
    logs = _eval_logs(4)
    _reduce(TorchTask, tm, logs)
    _reduce(JaxTask, jm, logs)
    state, jstate = tm.state_dict()["validate"], jm.state_dict()["validate"]
    assert [(k, cls) for k, (cls, _) in state] == [(k, cls) for k, (cls, _) in jstate]
    restored = tm.MetersDict()
    restored.load_state_dict(state)
    np.testing.assert_array_equal(restored["_area_union"].sum,
                                  tm.get_meter("validate", "_area_union").sum)
    assert tm.nanmean(np.array([np.nan, 1.0, 3.0])) == jm.nanmean(np.array([np.nan, 1.0, 3.0]))


def test_cross_process_sum_is_the_identity_on_one_process():
    log = {"area_union": np.ones(3), "nll_sum": 2.0}
    assert tm.cross_process_sum(log) is log
