"""The JAX optimizer states that ``tools/orbax_to_torch.py`` converts,
every optimizer of ``OPTIMIZERS``, a composite, a BitFit-frozen run and a
reduce_lr_on_plateau run with its scale at 0.5 (CPU, fp32, tiny widths).

A JAX update from seeded gradients, an EMA copy, saved by the JAX
``CheckpointManager``, converted and restored into the port's ``Trainer``:
the model bit for bit, the counts equal, a fresh plateau controller.  Then
one more update on both sides from the same batch (dropout off): the port's
``train_step`` on it, and the JAX optimizer on the gradient that step gave
the port's optimizer.  Parameters, optimizer state and EMA within
``tests/test_torch_optimizers.py``'s tolerance (1e-5 relative, 1e-7
absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ifseg_torch.checkpoint.convert import optimizer_state_from_jax, state_dict_from_jax
from ifseg_torch.train import optim as to
from ifseg_tpu.checkpoint.manager import CheckpointManager as JaxManager
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.train import optim as jo
from ifseg_tpu.train.ema import ema_init, ema_step
from ifseg_tpu.train.trainer import TrainState

from torch_orbax_utils import (NUM_SEG, TOTAL, flags, port_trainer, restore, seeded_grads,
                               tiny_params, tool, trace_each_model_once)  # noqa: F401
from torch_port_utils import passed_tmp, train_batch  # noqa: F401  (the fixture)

RTOL, ATOL = 1e-5, 1e-7  # tests/test_torch_optimizers.py's


def _jax_tree(trainer, named, like):
    """The port's tensors by parameter name as a tree of the JAX layout
    shaped like ``like`` (zeros where the port has no tensor)."""
    names = list(named)
    paths = to.jax_paths(trainer.model)
    leaves = {leaf.path: leaf.view([named[n] for n in names]).numpy()
              for leaf in to.jax_leaves(names, paths)}
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaves.get("/".join(str(k.key) for k in p),
                                            np.zeros(np.shape(x), np.float32))), like)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_state_close(got, want, what=""):
    """Two optimizer states (``state_dict`` form), tensors within the
    tolerance, everything else equal."""
    assert set(got) == set(want), what
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_state_close(got[k], v, f"{what}/{k}")
        elif torch.is_tensor(v):
            _close(got[k], v, f"{what}/{k}")
        else:
            assert got[k] == v, f"{what}/{k}"


CASES = {name: ("--optimizer=" + name,) for name in to.OPTIMIZERS if name != "composite"}
CASES["composite"] = ("--optimizer=composite", "--composite-base=lamb",
                      "--composite-groups=decoder/.*=adam@5e-3,encoder/layers_[0-9]{1,2}/ffn=sgd@0.02")
CASES["bitfit"] = ("--optimizer=adam", "--bitfit")
CASES["plateau"] = ("--optimizer=adam", "--lr-scheduler=reduce_lr_on_plateau")


@pytest.mark.parametrize("case", sorted(CASES))
def test_resumed_update_matches_jax(case, passed_tmp):
    argv = flags(passed_tmp / "jax", *CASES[case])
    jcfg = jax_flags(argv)
    params = jax.tree_util.tree_map(jnp.asarray, tiny_params())
    tx, _, _ = jo.build_optimizer(params, jcfg.model, jcfg.optimization, TOTAL)
    state = tx.init(params)
    upd, state = tx.update(seeded_grads(params, np.random.default_rng(3)), state, params)
    params = optax.apply_updates(params, upd)
    ema = ema_step(ema_init(params), params, jcfg.common.ema_decay)
    if case == "plateau":
        state = jo.set_lr_scale(state, 0.5)
    saved = TrainState(step=jnp.asarray(1, jnp.int32), params=params, opt_state=state,
                       ema_params=ema)
    jmgr = JaxManager(jcfg.checkpoint)
    jmgr.save(1, saved, extra={"epoch": 1, "metrics": {}})
    jmgr.finalize()
    tool.convert(str(passed_tmp / "jax"), str(passed_tmp / "port"), argv)

    trainer = port_trainer(argv)
    restore(trainer, str(passed_tmp / "port"))
    host = jax.device_get(saved)
    model = state_dict_from_jax(host.params)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, model[k]), k
    assert trainer.get_num_updates() == trainer.optimizer.count == 1
    assert trainer.plateau is None or trainer.plateau.scale == 1.0  # a fresh controller
    if case == "plateau":
        assert trainer.optimizer.lr_scale == 0.5 and trainer.optimizer.inner.lr_scale == 1.0

    # one more update from the same batch: the port's whole step, and the JAX
    # optimizer on the gradient that step handed the port's optimizer
    seen = {}
    step = trainer.optimizer.step

    def recording_step(grads):
        seen.update(zip(trainer.optimizer.names, (g.clone() for g in grads)))
        step(grads)

    trainer.optimizer.step = recording_step
    logs = trainer.train_step(train_batch(seed=11, num_seg=NUM_SEG))
    assert float(logs["n_nonfinite"]) == 0.0 and seen
    grads = _jax_tree(trainer, seen, host.params)
    upd, state = tx.update(grads, saved.opt_state, saved.params)
    params = optax.apply_updates(saved.params, upd)
    ema = ema_step(saved.ema_params, params, jcfg.common.ema_decay)

    want = state_dict_from_jax(jax.device_get(params))
    moved = 0
    for name, p in trainer.model.named_parameters():
        if name in want:
            _close(p.detach(), want[name], name)
            moved += bool((want[name] != model[name]).any())
    assert moved >= (10 if case == "bitfit" else 100)
    _assert_state_close(trainer.optimizer.state_dict(),
                        optimizer_state_from_jax(jax.device_get(state), jax.device_get(params),
                                                 trainer.optimizer), case)
    shadow = state_dict_from_jax(jax.device_get(ema))
    for name, v in trainer.ema.items():
        _close(v, shadow[name], f"ema {name}")
