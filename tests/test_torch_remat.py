"""Activation checkpointing of the port's layers (``models/layers.py
run_layer``) and the "auto" decision (``train/trainer.py``), on the CPU.

- With dropout and drop-path at 0.1, a checkpointed forward + backward under
  each policy gives the loss, every gradient and the dropout generator's
  state of the unchecked one bit for bit, and so does a train step; the
  forward with stats runs again in the backward under "full" only.
- ``Trainer.train_step`` with ``checkpoint_activations=True`` against the JAX
  package's, at ``tests/test_torch_trainer.py``'s tolerances (dropout off:
  the two packages draw different masks).
- ``resolve_remat_policy`` makes the JAX package's decision in every case of
  ``tests/test_remat_auto.py``, from the same bytes model (equal to 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ifseg_torch.ops.flash_attention as fa
from ifseg_torch.checkpoint.convert import adam_state_from_jax, state_dict_from_jax
from ifseg_torch.config import Config as TorchConfig
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.train import trainer as ttrainer
from ifseg_torch.train.trainer import Trainer as TorchTrainer
from ifseg_tpu.config import Config as JaxConfig
from ifseg_tpu.config import model_config_for_arch as jax_model_config
from ifseg_tpu.parallel.mesh import MeshConfig, build_mesh
from ifseg_tpu.train import trainer as jtrainer
from ifseg_tpu.train.trainer import Trainer as JaxTrainer

from test_torch_trainer import _with_adam_state
from torch_port_utils import JAX_ONLY, TINY, class_table, make_pair, train_batch

NUM_SEG = 5
POLICIES = ("full", "save-attn", "save-attn-ffn")
DROPPY = dict(dropout=0.1, encoder_drop_path_rate=0.1, decoder_drop_path_rate=0.1)


def _trainer(policy, seed=0):
    """A tiny trainer with dropout on; ``policy`` None = no checkpointing."""
    cfg = TorchConfig(model=torch_model_config("segofa_tiny", **dict(TINY, **DROPPY)))
    cfg.model.checkpoint_activations = policy is not None
    cfg.model.remat_policy = policy or "full"
    cfg.optimization.seed = seed
    tokens, lengths = class_table(NUM_SEG)
    return TorchTrainer(cfg, tokens, lengths, total_num_updates=10, device="cpu").init_state()


def _stats_forwards(monkeypatch):
    """A counter of the forward-with-stats calls (the plain version on the CPU)."""
    calls = {"n": 0}
    plain = fa.attention_bias_stats_reference

    def counting(*args):
        calls["n"] += 1
        return plain(*args)

    monkeypatch.setattr(fa, "attention_bias_stats_reference", counting)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpointed_gradients_are_bit_equal(policy, monkeypatch):
    calls = _stats_forwards(monkeypatch)
    out = {}
    for key in (None, policy):
        tr = _trainer(key)
        batch = tr.prepare_batch(train_batch(3))
        tr.model.train()
        calls["n"] = 0
        loss = tr._loss_fn(batch)
        loss.backward()
        out[key] = (loss.detach(), {n: p.grad.clone() for n, p in tr.model.named_parameters()
                                    if p.grad is not None},
                    tr.generator.get_state(), calls["n"])
    (l0, g0, s0, n0), (l1, g1, s1, n1) = out[None], out[policy]
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and len(g0) > 50
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert torch.equal(s0, s1)
    sites = 2 + 2 * 2  # encoder self; decoder self and cross, tiny = 2 + 2 layers
    assert n0 == sites and n1 == (2 * sites if policy == "full" else sites)


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpointed_train_steps_are_bit_equal(policy):
    a, b = _trainer(None, seed=4), _trainer(policy, seed=4)
    for seed in range(2):
        la, lb = a.train_step(train_batch(seed)), b.train_step(train_batch(seed))
        for key in ("loss", "gnorm", "seg_loss"):
            assert torch.equal(la[key], lb[key]), key
    for (name, pa), (_, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def step_against_jax(model: dict, arch: str = "segofa_tiny", size: int = 64):
    """One ``train_step`` of both trainers from the same weights (``make_pair``
    at ``model``'s fields), Adam moments and batch, held as
    ``test_torch_trainer.py::test_train_step_matches_jax`` holds it."""
    model = dict(model, patch_image_size=size, orig_patch_image_size=size, num_seg_tokens=NUM_SEG)
    jcfg = JaxConfig().replace(model=jax_model_config(arch, **model, **JAX_ONLY))
    jcfg.task.num_seg_tokens, jcfg.task.patch_image_size = NUM_SEG, size
    jcfg.optimization.lr = 1e-3
    tokens, lengths = class_table(NUM_SEG)
    _, params, _ = make_pair(seed=0, **{k: v for k, v in model.items()
                                        if k not in ("checkpoint_activations", "remat_policy")})
    mesh = build_mesh(MeshConfig(data_parallel=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(jcfg, mesh, tokens, lengths, total_num_updates=20)
    jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    jtr.state = jtr.state.replace(
        step=jnp.asarray(3, jnp.int32),
        opt_state=_with_adam_state(jtr.state.opt_state, np.random.default_rng(7)))
    before = jax.device_get(jtr.state.params)

    tcfg = TorchConfig(model=torch_model_config(arch, **model, **JAX_ONLY))
    tcfg.optimization.lr = 1e-3
    ttr = TorchTrainer(tcfg, tokens, lengths, total_num_updates=20, device="cpu")
    ttr.init_state(state_dict_from_jax(params))
    ttr.load_optimizer_state(adam_state_from_jax(jax.device_get(jtr.state.opt_state), before))
    assert jcfg.model.checkpoint_activations and tcfg.model.checkpoint_activations
    t_before = {n: p.detach().clone() for n, p in ttr.model.named_parameters()}

    batch = train_batch(seed=11, size=size, num_seg=NUM_SEG)
    jlogs, tlogs = jtr.train_step(batch), ttr.train_step(batch)
    for key in ("loss", "imfree_loss", "seg_loss", "nll_loss"):
        np.testing.assert_allclose(float(tlogs[key]), float(jlogs[key]), rtol=2e-5, err_msg=key)
    np.testing.assert_allclose(float(tlogs["gnorm"]), float(jlogs["gnorm"]), rtol=1e-3)
    after, start = state_dict_from_jax(jax.device_get(jtr.state.params)), state_dict_from_jax(before)
    moved = 0
    for name, p in ttr.model.named_parameters():
        if not ttr.mask[name]:
            continue
        want = (after[name] - start[name]).numpy()
        got = (p.detach() - t_before[name]).numpy()
        err, ref = np.linalg.norm(got - want), np.linalg.norm(want)
        assert err <= 2e-3 * ref + 1e-9, f"{name}: {err} vs {ref}"
        moved += ref > 0
    assert moved > 100


@pytest.mark.parametrize("policy", ["full", "save-attn"])
def test_checkpointed_train_step_matches_jax(policy):
    """Both packages checkpoint their layers under ``policy``."""
    step_against_jax(dict(TINY, checkpoint_activations=True, remat_policy=policy))


def test_unknown_policy_raises():
    tr = _trainer("save-attn")
    tr.cfg.model.remat_policy = "save-everything"
    with pytest.raises(ValueError, match="remat_policy"):
        tr.train_step(train_batch(0))


HBM_V5E = 16e9

# the cases of tests/test_remat_auto.py: (arch, batch, data shards, model
# fields, supervised)
AUTO_CASES = {
    "base-batch16": ("segofa_base", 16, 1, {}, False),
    "base-batch64": ("segofa_base", 64, 1, {}, False),
    "base-batch32": ("segofa_base", 32, 1, {}, False),
    "data-shards": ("segofa_base", 64, 4, {}, False),
    "supervised": ("segofa_base", 2, 1, {}, True),
    "explicit-policy": ("segofa_base", 16, 1, {"remat_policy": "save-attn-ffn"}, False),
    "explicit-off": ("segofa_base", 64, 1, {"checkpoint_activations": False}, False),
    "large-batch8": ("segofa_large", 8, 1, {}, False),
    "huge-batch32-h100": ("segofa_huge", 32, 1, {}, False),
}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_resolve_remat_policy_matches_jax(case):
    arch, batch, shards, fields, supervised = AUTO_CASES[case]
    hbm = 85_031_714_816.0 if case.endswith("h100") else HBM_V5E  # an H100 80GB's total
    decided = []
    for config, model_config, resolve in (
            (JaxConfig, jax_model_config, jtrainer.resolve_remat_policy),
            (TorchConfig, torch_model_config, ttrainer.resolve_remat_policy)):
        cfg = config().replace(model=model_config(arch))
        cfg.optimization.batch_size = batch
        cfg.criterion.unsupervised_segmentation = not supervised
        for k, v in fields.items():
            setattr(cfg.model, k, v)
        resolve(cfg, n_data_shards=shards, hbm_bytes=hbm)
        decided.append((cfg.model.checkpoint_activations, cfg.model.remat_policy))
    assert decided[0] == decided[1]
    if case == "huge-batch32-h100":  # what the card decides for Huge at batch 32
        assert decided[1] == (True, "save-attn")


@pytest.mark.parametrize("arch,batch", [("segofa_base", 16), ("segofa_huge", 16),
                                        ("segofa_huge", 32), ("segofa_tiny", 2)])
def test_bytes_model_equals_jax(arch, batch):
    for ema in (False, True):
        want = jtrainer.estimate_train_hbm_bytes(jax_model_config(arch), batch, ema=ema)
        got = ttrainer.estimate_train_hbm_bytes(torch_model_config(arch), batch, ema=ema)
        assert got == pytest.approx(want, rel=1e-12)


def test_trainer_resolves_auto_on_its_device():
    """A CPU trainer decides from the JAX package's default memory (its CPU
    reports none): off at the tiny size, as the JAX trainer decides."""
    cfg = TorchConfig(model=torch_model_config("segofa_tiny", **TINY))
    assert (cfg.model.checkpoint_activations, cfg.model.remat_policy) == (True, "auto")
    TorchTrainer(cfg, *class_table(NUM_SEG), device="cpu")
    assert (cfg.model.checkpoint_activations, cfg.model.remat_policy) == (False, "save-attn")
    assert ttrainer.device_memory_bytes("cpu") == 16e9
    jcfg = JaxConfig().replace(model=jax_model_config("segofa_tiny", **TINY))
    jtrainer.resolve_remat_policy(jcfg)
    assert (jcfg.model.checkpoint_activations, jcfg.model.remat_policy) == (False, "save-attn")
