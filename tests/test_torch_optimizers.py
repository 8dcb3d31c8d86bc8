"""The port's optimizers against the JAX package's (``train/optim.py``), as
``tests/test_optimizers.py`` holds those: CPU, fp32.

- Five steps of every optimizer (and composite groups) on the tiny model's
  parameters, converted from the JAX tree, with the same seeded gradients:
  every trainable parameter within 1e-5 relative (1e-7 absolute), the
  optimizer's count equal.
- Composite group membership equals the JAX package's labels on
  ``segofa_tiny``, a brace quantifier included (each group's lr marks it).
- ``jax_paths`` names every parameter by the JAX leaf it comes from.
- ``DynamicLossScaler`` gives the JAX package's scale and skip sequence.
"""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.config import OptimizationConfig as TorchOpt
from ifseg_torch.train import optim as to
from ifseg_tpu.config import OptimizationConfig as JaxOpt
from ifseg_tpu.train import optim as jo

from torch_port_utils import make_pair

TOTAL = 20
# everything trains but the stem, whose batch norms are buffers in the port
TRAINABLE = dict(freeze_encoder_embedding=False, freeze_decoder_embedding=False,
                 freeze_seg_embedding=False)
PORT_ONLY = "decoder.embed_image_positions.weight"  # no JAX leaf; its gradient is 0
OPTIMIZERS = ("adam", "adafactor", "lamb", "fused_lamb", "sgd", "nag", "adagrad", "adadelta",
              "adamax")
COMPOSITE = dict(optimizer="composite", composite_base="lamb",
                 composite_groups="decoder/.*=adam@5e-3,encoder/layers_[0-9]{1,2}/ffn=sgd@0.02")


@functools.lru_cache(maxsize=None)
def _pair():
    """One JAX init for the module (it takes most of a test's time)."""
    return make_pair(seed=0, **TRAINABLE)


def _pair_and_optimizers(**opt):
    jmodel, params, tmodel = _pair()
    tmodel = copy.deepcopy(tmodel)
    tx, _, _ = jo.build_optimizer(params, jmodel.cfg, JaxOpt(**opt), TOTAL)
    topt, _, mask = to.build_optimizer(tmodel, tmodel.cfg, TorchOpt(**opt), TOTAL)
    return params, tx, tmodel, topt, mask


def _grads(params, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda x: rng.normal(0.0, scale, np.shape(x)).astype(np.float32), params)


def _run_both(steps, **opt):
    params, tx, tmodel, topt, mask = _pair_and_optimizers(**opt)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(steps):
        g = _grads(params, rng)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = state_dict_from_jax(g)
        topt.step([tg[n] for n in topt.names])
    return state_dict_from_jax(jax.device_get(jp)), tmodel, topt, mask


@pytest.mark.parametrize("name", OPTIMIZERS + ("composite",))
def test_five_steps_match_jax(name):
    opt = dict(lr=1e-2, lr_scheduler="cosine", warmup_updates=2, weight_decay=0.01,
               momentum=0.9)
    opt.update(COMPOSITE if name == "composite" else dict(optimizer=name))
    want, tmodel, topt, mask = _run_both(5, **opt)
    assert topt.count == 5
    trained = 0
    for pname, p in tmodel.named_parameters():
        if pname == PORT_ONLY or not mask[pname]:
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[pname].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=pname)
        trained += 1
    assert trained > 100


def _labels_by_lr(updates):
    """A parameter's group from its update under unit gradients, lr fixed."""
    return {n: float(-u.reshape(-1)[0]) for n, u in updates.items()}


@pytest.mark.parametrize("spec", [
    "encoder/layers_[0-9]{1,2}/self_attn=sgd@0.5,decoder/layers_1/.*fc[12]=sgd@0.25,"
    "rel_pos_table=sgd@0.125",
    "kernel=sgd@0.5,embedding=sgd@0.25",
    "decoder/.*=adam@5e-5",
], ids=["brace", "leaf-names", "decoder"])
def test_composite_groups_are_jax_labels(spec):
    opt = dict(optimizer="composite", composite_base="sgd", composite_groups=spec, lr=0.0625,
               lr_scheduler="fixed", weight_decay=0.0, momentum=0.0)
    params, tx, tmodel, topt, mask = _pair_and_optimizers(**opt)
    ones = jax.tree_util.tree_map(lambda x: np.ones(np.shape(x), np.float32), params)
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, ones), tx.init(params),
                       jax.tree_util.tree_map(jnp.asarray, params))
    want = _labels_by_lr(state_dict_from_jax(jax.device_get(upd)))
    got = _labels_by_lr(dict(zip(topt.names, topt.update([torch.ones_like(p)
                                                           for p in topt.params]))))
    names = [n for n in got if n != PORT_ONLY]
    assert len(names) > 100
    for n in names:
        assert got[n] == pytest.approx(want[n], rel=1e-6), n
    lrs = {round(v, 9) for v in got.values()}
    assert len(lrs) >= 2  # the spec splits the tree
    jgroups = jo.parse_composite_groups(spec)
    assert to.parse_composite_groups(spec) == jgroups


def test_jax_paths_name_each_parameter_by_its_leaf():
    """Every JAX leaf filled with its own number lands, through the
    converter, on the port's parameters whose path is that leaf's."""
    _, params, tmodel = _pair()
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i + 1, np.float32) for i, (_, x) in enumerate(flat)])
    sd = state_dict_from_jax(tagged)
    got = to.jax_paths(tmodel)
    for name, _ in tmodel.named_parameters():
        if name == PORT_ONLY:
            continue
        tag = int(sd[name].reshape(-1)[0])
        assert got[name][0] == paths[tag - 1], name
    assert {got[n][1] for n in got} == {"same", "linear", "stacked", "conv"}
    assert all(n.startswith("encoder.embed_images.") for n in got if got[n][1] == "conv")


def test_adafactor_factors_on_the_jax_layout():
    """A square (in, out) kernel is factored over the JAX layout's axes: the
    port transposes the torch weight to choose them (optax's argsort puts
    axis 0 first for equal sizes)."""
    w = torch.randn(128, 128)
    leaf = to.JaxLeaf("k", [0], "linear")
    opt = to.Adafactor([w], lambda s: 1e-2, [leaf])
    assert opt.dims == [(0, 1)]
    g = np.random.default_rng(0).normal(size=(128, 128)).astype(np.float32)
    tx = optax.adafactor(learning_rate=1e-2)
    kernel = jnp.asarray(w.numpy().T)
    upd, _ = tx.update(jnp.asarray(g.T), tx.init(kernel), kernel)
    got = opt.update([torch.from_numpy(g)])[0]
    np.testing.assert_allclose(got.numpy().T, np.asarray(upd), rtol=1e-5, atol=1e-9)


def test_dynamic_loss_scaler_matches_jax():
    rng = np.random.default_rng(0)
    overflows = [bool(x) for x in rng.random(300) < 0.05] + [True] * 5 + [False] * 40
    for window, tol in ((8, 0.0), (16, 0.25)):
        j = jo.DynamicLossScaler(init_scale=2.0 ** 7, scale_window=window, tolerance=tol,
                                 min_loss_scale=0.5)
        t = to.DynamicLossScaler(init_scale=2.0 ** 7, scale_window=window, tolerance=tol,
                                 min_loss_scale=0.5)
        seq_j = [(j.update(o), j.scale) for o in overflows]
        seq_t = [(t.update(o), t.scale) for o in overflows]
        assert seq_t == seq_j
        assert len({s for _, s in seq_t}) > 3


def test_fused_lamb_is_lamb_and_unknown_names_raise():
    cfg = types.SimpleNamespace(weight_decay=0.0, adam_betas=(0.9, 0.999))
    w = [torch.ones(4)]
    paths = {"0": ("w", "same")}
    a = to._single_optimizer("lamb", w, ["0"], to.fixed_schedule(0.1), cfg, paths)
    b = to._single_optimizer("fused_lamb", w, ["0"], to.fixed_schedule(0.1), cfg, paths)
    assert type(a) is type(b) is to.Lamb
    with pytest.raises(ValueError, match="unknown optimizer"):
        to._single_optimizer("rmsprop", w, ["0"], to.fixed_schedule(0.1), cfg, paths)
