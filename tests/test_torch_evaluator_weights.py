"""The ``Evaluator`` leaves the model it is given alone (CPU, the tiny model,
bf16 compute, so the evaluator's forward needs weights in another dtype than
the trainer's fp32 parameters).

An evaluator built on ``Trainer.model`` must not cast the trainer's weights:
``FairseqAdam`` updates them in place and keeps no fp32 master copy, so a
weight turned bf16 would lose every update smaller than its bf16 step (an
update of 5e-5 on a weight of 1.0, where the step is 2^-7).  The evaluator
runs a serving copy refreshed at each ``eval_dataset``; its results must
equal those of an evaluator built fresh on a copy of the stepped model (the
same computation on the same weights: equal areas, equal nll).
"""

import copy

import numpy as np
import pytest
import torch

import ifseg_torch.eval.evaluator as tev
from ifseg_torch.config import Config
from ifseg_torch.config import model_config_for_arch
from ifseg_torch.data.segmentation_dataset import EvalSample
from ifseg_torch.train.trainer import Trainer

from torch_port_utils import JAX_ONLY, TINY, class_table, train_batch

NUM_SEG = 5
LR = 5e-5
AREAS = ("area_intersect", "area_pred_label", "area_label", "area_union")


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(tev, "BUCKET", 64)
    monkeypatch.setattr(tev, "ROW_CHUNK", 32)


def _cfg():
    cfg = Config(model=model_config_for_arch("segofa_tiny", **dict(TINY, **JAX_ONLY,
                                                                    dtype="bfloat16")))
    cfg.optimization.lr = LR
    cfg.optimization.seed = 0
    cfg.criterion.resnet_iters = 2
    cfg.criterion.resnet_topk = 2
    return cfg


def _trainer():
    tokens, lengths = class_table(NUM_SEG)
    return Trainer(_cfg(), tokens, lengths, total_num_updates=20, device="cpu").init_state()


class _Rows:
    """Two uint8 rows of one bucket, as a dataset."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.samples = [EvalSample(
            patch_image=rng.integers(0, 256, size=(64, 60, 3), dtype=np.uint8),
            src_tokens=rng.integers(4, 100, size=(10,)).astype(np.int32),
            bos_token=np.zeros((1,), np.int32),
            ori_semantic_seg=rng.integers(0, NUM_SEG + 1, size=(70, 64)).astype(np.int32),
            ori_shape=(70, 64, 3), id=i) for i in range(2)]

    def __len__(self):
        return len(self.samples)

    def get_eval_sample(self, i):
        return self.samples[i]


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_eval_dataset_leaves_the_trainers_parameters_as_they_were():
    trainer = _trainer()
    before = {n: (p, p.dtype, p.device, p.detach().clone())
              for n, p in trainer.model.named_parameters()}
    evaluator = tev.Evaluator(trainer.cfg, trainer.model, device="cpu")
    evaluator.eval_dataset(_Rows(), batch_size=2)
    assert trainer.model.training  # its flag is the trainer's, not the evaluator's
    for n, p in trainer.model.named_parameters():
        obj, dtype, device, value = before[n]
        assert p is obj and p.dtype == dtype == torch.float32 and p.device == device, n
        assert torch.equal(p, value), n
    # the serving copy does compute in bf16: the layers' linears were cast there
    fc1 = evaluator.model.encoder.layers[0].fc1.weight
    assert fc1.dtype == torch.bfloat16 and trainer.model.encoder.layers[0].fc1.weight.dtype == torch.float32


def test_small_adam_update_still_lands_after_an_evaluation():
    """A weight of 1.0 moved by an update of about lr = 5e-5: kept in fp32 it
    moves (1.0 ± 5e-5 is an fp32 value); turned bf16 it would stay at 1.0."""
    trainer, twin = _trainer(), _trainer()
    tev.Evaluator(trainer.cfg, trainer.model, device="cpu").eval_dataset(_Rows(), batch_size=2)
    name = "encoder.layers.0.fc1.weight"
    for tr in (trainer, twin):
        with torch.no_grad():
            dict(tr.model.named_parameters())[name][0, 0] = 1.0
    batch = train_batch(3, num_seg=NUM_SEG)
    out = trainer.train_step(batch)
    twin.train_step(batch)
    w = dict(trainer.model.named_parameters())[name]
    step = abs(float(w.detach()[0, 0]) - 1.0)
    lr = float(out["lr"])
    assert w.dtype == torch.float32 and 0.5 * lr <= step <= 2.0 * lr * (1 + 0.1), (step, lr)
    # the evaluated trainer stepped exactly as one that never met an evaluator
    for (n, p), (_, q) in zip(trainer.model.named_parameters(), twin.model.named_parameters()):
        assert torch.equal(p, q), n


def test_evaluation_after_a_step_equals_a_fresh_evaluator_on_the_stepped_model():
    trainer = _trainer()
    evaluator = tev.Evaluator(trainer.cfg, trainer.model, device="cpu")
    first = evaluator.eval_dataset(_Rows(), batch_size=2)
    trainer.train_step(train_batch(4, num_seg=NUM_SEG))
    again = evaluator.eval_dataset(_Rows(), batch_size=2)
    fresh = tev.Evaluator(trainer.cfg, copy.deepcopy(trainer.model),
                          device="cpu").eval_dataset(_Rows(), batch_size=2)
    assert len(again) == len(fresh) == 1
    for key in AREAS + tuple(a + "_resnet_postprocess" for a in AREAS) + ("nll_sum", "nll_cnt"):
        np.testing.assert_array_equal(again[0][key], fresh[0][key], err_msg=key)
    # and the step did reach the evaluator: its refreshed weights give another loss
    assert float(again[0]["nll_loss"]) != float(first[0]["nll_loss"])
