"""The port's schedules and plateau controller against the JAX package's
(``train/optim.py``), as ``tests/test_lr_schedulers.py`` holds those.

- Every ``--lr-scheduler`` through ``build_schedule`` with its knobs, at
  every step 0 … 60 of a 50-update run: within 1e-6 relative, or 1e-7 of the
  peak lr absolute (JAX computes in fp32, the port in double: near the end
  of the cosine, 1 + cos(x) cancels and JAX's fp32 cos leaves up to 6e-8 of
  lr, 5e-5 of the value; the port's double is the more accurate).
- The plateau controller's scale sequence equals JAX's on seeded metrics.
- ``set_lr_scale`` under ``reduce_lr_on_plateau`` scales every optimizer's
  updates (composite's too) as the JAX package's does: the parameters after
  an update at scale 0.5 within 1e-5 relative (1e-7 absolute) of JAX's, and
  the port's updates half of its own at scale 1 (1e-6).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.config import OptimizationConfig as TorchOpt
from ifseg_torch.train import optim as to
from ifseg_tpu.train import optim as jo

from test_torch_optimizers import COMPOSITE, OPTIMIZERS, PORT_ONLY, _pair_and_optimizers
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

TOTAL = 50
KNOBS = types.SimpleNamespace(
    warmup_updates=7, warmup_ratio=0.0, max_lr=3e-3, lr_period_updates=9, lr_shrink=0.5,
    hold_updates=11, manual_lr_schedule="2:5e-4, 4:2e-4", max_epoch=5)
CASES = {
    "cosine": {}, "cosine-ratio": dict(warmup_ratio=0.2, warmup_updates=0),
    "inverse_sqrt": {}, "inverse_sqrt-no-warmup": dict(warmup_updates=0),
    "polynomial_decay": {}, "polynomial_decay-ratio": dict(warmup_ratio=0.1),
    "fixed": {}, "pass_through": {}, "reduce_lr_on_plateau": {},
    "triangular": {}, "triangular-defaults": dict(max_lr=0.0, lr_period_updates=0, lr_shrink=0.0),
    "tri_stage": {}, "tri_stage-no-hold": dict(hold_updates=0),
    "manual": {}, "manual-empty": dict(manual_lr_schedule=""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_schedules_match_jax(case):
    name = case.split("-")[0]
    knobs = types.SimpleNamespace(**dict(vars(KNOBS), **CASES[case]))
    want = jo.build_schedule(name, 1e-3, TOTAL, knobs)
    got = to.build_schedule(name, 1e-3, TOTAL, knobs)
    values = []
    for step in range(61):
        values.append(float(got(step)))
        np.testing.assert_allclose(values[-1], float(want(step)), rtol=1e-6, atol=1e-7 * 1e-3,
                                   err_msg=f"{case} step {step}")
    if name not in ("fixed", "pass_through", "reduce_lr_on_plateau") and "empty" not in case:
        assert len(set(values)) > 2, case


def test_schedules_without_a_config_match_jax():
    for name in to.SCHEDULERS:
        want, got = jo.build_schedule(name, 0.01, 100, None), to.build_schedule(name, 0.01, 100)
        for step in (0, 1, 50, 99, 100):
            np.testing.assert_allclose(float(got(step)), float(want(step)), rtol=1e-6,
                                       atol=1e-7 * 0.01, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("maximize,patience", [(True, 1), (False, 0), (False, 2)])
def test_plateau_sequence_matches_jax(maximize, patience):
    rng = np.random.default_rng(patience)
    metrics = np.cumsum(rng.normal(0.0, 1.0, 60)).tolist()
    metrics[10:14] = [metrics[9]] * 4  # a flat stretch: no improvement past the threshold
    j = jo.ReduceLROnPlateau(shrink=0.5, patience=patience, maximize=maximize)
    t = to.ReduceLROnPlateau(shrink=0.5, patience=patience, maximize=maximize)
    seq_j = [j.step(m) for m in metrics]
    seq_t = [t.step(m) for m in metrics]
    assert seq_t == seq_j and min(seq_t) < 1.0
    assert (t.best, t.bad_count, t.scale) == (j.best, j.bad_count, j.scale)
    other = to.ReduceLROnPlateau(shrink=0.5, patience=patience, maximize=maximize)
    other.load_state_dict(t.state_dict())
    assert [other.step(m) for m in metrics[:5]] == [t.step(m) for m in metrics[:5]]


@pytest.mark.parametrize("name", OPTIMIZERS + ("composite",))
def test_set_lr_scale_scales_every_optimizer_as_jax(name):
    opt = dict(lr=1e-2, lr_scheduler="reduce_lr_on_plateau", weight_decay=0.01, momentum=0.9)
    opt.update(COMPOSITE if name == "composite" else dict(optimizer=name))
    params, tx, tmodel, topt, mask = _pair_and_optimizers(**opt)
    assert isinstance(topt, to.LrScaled)
    rng = np.random.default_rng(5)
    g = jax.tree_util.tree_map(lambda x: rng.normal(0, 0.1, np.shape(x)).astype(np.float32),
                               params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    half, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jo.set_lr_scale(state, 0.5), jp)
    want = state_dict_from_jax(jax.device_get(jax.tree_util.tree_map(jnp.add, jp, half)))
    tg = state_dict_from_jax(g)
    grads = [tg[n] for n in topt.names]
    snapshot = to.build_optimizer(tmodel, tmodel.cfg, TorchOpt(**opt), 20)[0]  # fresh state
    full = dict(zip(snapshot.names, snapshot.update(grads)))
    to.set_lr_scale(topt, 0.5)
    got = dict(zip(topt.names, topt.update(grads)))
    assert topt.state_dict()["lr_scale"] == 0.5
    checked = 0
    for n in topt.names:
        if n == PORT_ONLY:
            continue
        after = (dict(tmodel.named_parameters())[n].detach() + got[n]).numpy()
        np.testing.assert_allclose(after, want[n].numpy(), rtol=1e-5, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(got[n].numpy(), 0.5 * full[n].numpy(), rtol=1e-6, atol=1e-12,
                                   err_msg=n)
        checked += 1
    assert checked > 100


def test_adam_takes_its_own_scale_without_the_plateau():
    """Without reduce_lr_on_plateau only Adam has a scale (in its state, as
    the JAX package's ``FairseqAdamState``); it scales its lr."""
    w = [torch.ones(4)]
    adam = to.FairseqAdam(w, to.fixed_schedule(0.1))
    to.set_lr_scale(adam, 0.25)
    tx = jo.fairseq_adam(jo.fixed_schedule(0.1))
    state = jo.set_lr_scale(tx.init({"w": jnp.ones(4)}), 0.25)
    upd, _ = tx.update({"w": jnp.full(4, 0.3)}, state, {"w": jnp.ones(4)})
    got = adam.update([torch.full((4,), 0.3)])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(upd["w"]), rtol=1e-6)
    sgd = to.Sgd(w, to.fixed_schedule(0.1))
    to.set_lr_scale(sgd, 0.25)  # no scale to set: a no-op, as in the JAX package
    np.testing.assert_allclose(sgd.update([torch.ones(4)])[0].numpy(), -0.1, rtol=1e-6)
