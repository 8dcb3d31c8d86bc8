"""The port's ``Trainer`` against the JAX package's (CPU, fp32, tiny config).

One ``train_step`` on the same weights, Adam moments and batch: loss and
monitoring loss 2e-5 relative, gnorm 1e-3 relative (it sums the squared
gradients that ``test_torch_train_model.py`` holds to 1e-3 per tensor), lr
1e-6, confusion areas equal, and the parameter delta per tensor
||Δ_port − Δ_jax|| ≤ 2e-3 · ||Δ_jax|| + 1e-9.  Both trainers start from the
same non-zero moments (``adam_state_from_jax``): with the second moment well
above the gradients' rounding noise the update is smooth in the gradient, so
the delta measures the whole step and not the sign of noise.

The rest holds the port's trainer to its own contract: accumulation, the
non-finite skip, freezing, EMA, the uint8 wire, and dropout / DropPath that
follow ``module.training`` and repeat from the generator's seed.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import adam_state_from_jax, state_dict_from_jax
from ifseg_torch.config import Config as TorchConfig
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.models.attention import Dropout, set_generator
from ifseg_torch.models.layers import DropPath, EncoderLayer
from ifseg_torch.train.trainer import Trainer as TorchTrainer
from ifseg_tpu.config import Config as JaxConfig
from ifseg_tpu.config import model_config_for_arch as jax_model_config
from ifseg_tpu.models.segofa import SegOFAVariables
from ifseg_tpu.parallel.mesh import MeshConfig, build_mesh
from ifseg_tpu.train.trainer import Trainer as JaxTrainer

from torch_port_utils import JAX_ONLY, TINY, class_table, perturb, train_batch

NUM_SEG = 5
LR = 1e-3
TOTAL = 20


def _torch_cfg(**model_overrides):
    model = dict(TINY, **JAX_ONLY)
    model.update(model_overrides)
    cfg = TorchConfig(model=torch_model_config("segofa_tiny", **model))
    cfg.optimization.lr = LR
    return cfg


def _torch_trainer(cfg=None, params=None, seed=0):
    cfg = cfg or _torch_cfg()
    tokens, lengths = class_table(NUM_SEG)
    if params is None:
        cfg.optimization.seed = seed
    return TorchTrainer(cfg, tokens, lengths, total_num_updates=TOTAL, device="cpu").init_state(params)


def _with_adam_state(node, rng):
    """The optimizer state with count 3 and numpy-seeded moments."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        mu = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(0, 1e-3, x.shape), jnp.float32), node.mu)
        nu = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.uniform(1e-4, 1e-2, x.shape), jnp.float32), node.nu)
        return node._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu)
    if isinstance(node, dict):
        return {k: _with_adam_state(v, rng) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[_with_adam_state(c, rng) for c in node])
    return node


def test_train_step_matches_jax():
    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=jax_model_config("segofa_tiny", **TINY, **JAX_ONLY))
    jcfg.task.num_seg_tokens = NUM_SEG
    jcfg.task.patch_image_size = 64
    jcfg.optimization.lr = LR
    tokens, lengths = class_table(NUM_SEG)
    _, params = SegOFAVariables.init(jcfg.model, jax.random.PRNGKey(0))
    params = perturb(params, 0)
    mesh = build_mesh(MeshConfig(data_parallel=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(jcfg, mesh, tokens, lengths, total_num_updates=TOTAL)
    jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    jtr.state = jtr.state.replace(
        step=jnp.asarray(3, jnp.int32),
        opt_state=_with_adam_state(jtr.state.opt_state, np.random.default_rng(7)),
    )
    before = jax.device_get(jtr.state.params)  # after the seg-embedding init
    adam = adam_state_from_jax(jax.device_get(jtr.state.opt_state), before)

    ttr = _torch_trainer(params=state_dict_from_jax(params))
    ttr.load_optimizer_state(adam)
    assert ttr.get_num_updates() == 3
    t_before = {n: p.detach().clone() for n, p in ttr.model.named_parameters()}
    for name, want in state_dict_from_jax(before).items():
        if name in t_before:  # same start, the seg-embedding init included
            np.testing.assert_allclose(t_before[name].numpy(), want.numpy(), atol=1e-6, rtol=1e-6)

    batch = train_batch(seed=11)
    jlogs = jtr.train_step(batch)
    tlogs = ttr.train_step(batch)

    assert set(tlogs) == set(jlogs)
    for key in ("loss", "imfree_loss", "seg_loss", "nll_loss"):
        np.testing.assert_allclose(float(tlogs[key]), float(jlogs[key]), rtol=2e-5, err_msg=key)
    np.testing.assert_allclose(float(tlogs["gnorm"]), float(jlogs["gnorm"]), rtol=1e-3)
    np.testing.assert_allclose(float(tlogs["lr"]), float(jlogs["lr"]), rtol=1e-6)
    assert float(tlogs["n_nonfinite"]) == float(jlogs["n_nonfinite"]) == 0.0
    for key in jlogs:
        if key.startswith("area_"):
            np.testing.assert_array_equal(tlogs[key].numpy(), np.asarray(jlogs[key]), err_msg=key)
    assert ttr.get_num_updates() == jtr.get_num_updates() == 4
    np.testing.assert_allclose(ttr.get_lr(), jtr.get_lr(), rtol=1e-6)

    after = state_dict_from_jax(jax.device_get(jtr.state.params))
    start = state_dict_from_jax(before)
    moved = 0
    for name, p in ttr.model.named_parameters():
        want = (after[name] - start[name]).numpy()
        got = (p.detach() - t_before[name]).numpy()
        if not ttr.mask[name]:
            assert not got.any() and not want.any(), name
            continue
        err, ref = np.linalg.norm(got - want), np.linalg.norm(want)
        assert err <= 2e-3 * ref + 1e-9, f"{name}: {err} vs {ref}"
        moved += ref > 0
    assert moved > 100


def _no_unknown(batch):
    batch = dict(batch)
    batch["aux_target"] = np.minimum(batch["aux_target"], NUM_SEG - 1)
    return batch


def test_two_microbatch_accumulation_equals_the_big_batch():
    """Equal valid counts per microbatch, so the mean of the two microbatch
    losses is the big batch's loss; fp32 summation order only: 1e-5."""
    batch = _no_unknown(train_batch(seed=5, batch=4))
    one, two = _torch_cfg(), _torch_cfg()
    two.optimization.update_freq = 2
    for cfg in (one, two):
        cfg.criterion.monitor_real_batch = False
    a, b = _torch_trainer(one, seed=3), _torch_trainer(two, seed=3)
    la, lb = a.train_step(batch), b.train_step(batch)
    np.testing.assert_allclose(float(lb["loss"]), float(la["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(lb["gnorm"]), float(la["gnorm"]), rtol=1e-4)
    for (name, pa), (_, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        np.testing.assert_allclose(pb.detach().numpy(), pa.detach().numpy(), atol=2e-6,
                                   rtol=1e-4, err_msg=name)


def test_nonfinite_gradient_skips_the_whole_update(monkeypatch):
    cfg = _torch_cfg()
    cfg.common.ema_decay = 0.9
    cfg.criterion.monitor_real_batch = False
    tr = _torch_trainer(cfg, seed=1)
    batch = train_batch(seed=6)
    tr.train_step(batch)  # moments and EMA are non-trivial now
    snap = lambda: copy.deepcopy((
        [p.detach().clone() for p in tr.model.parameters()], tr.optimizer.mu, tr.optimizer.nu,
        tr.optimizer.count, list(tr.ema.values()), tr.step))
    before = snap()
    real_loss = tr._loss_fn
    monkeypatch.setattr(tr, "_loss_fn", lambda b: real_loss(b) * float("nan"))
    logs = tr.train_step(batch)
    assert float(logs["n_nonfinite"]) == 1.0 and not np.isfinite(float(logs["gnorm"]))
    after = snap()
    assert after[3] == before[3] == 1 and after[5] == before[5] == 1
    for group_a, group_b in zip((after[0], after[1], after[2], after[4]),
                                (before[0], before[1], before[2], before[4])):
        assert all(torch.equal(x, y) for x, y in zip(group_a, group_b))
    monkeypatch.setattr(tr, "_loss_fn", real_loss)
    logs = tr.train_step(batch)
    assert float(logs["n_nonfinite"]) == 0.0 and tr.get_num_updates() == 2


def test_frozen_stay_trainable_move_and_ema_follows():
    cfg = _torch_cfg()
    cfg.common.ema_decay = 0.5
    cfg.criterion.monitor_real_batch = False
    tr = _torch_trainer(cfg, seed=2)
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.train_step(train_batch(seed=7))
    frozen = [n for n, t in tr.mask.items() if not t]
    assert "encoder.embed_tokens.weight" in frozen and "decoder.seg_embed_tokens.weight" in frozen
    assert any(n.startswith("encoder.embed_images.") for n in frozen)
    for name, p in tr.model.named_parameters():
        if tr.mask[name]:
            if start[name].any():  # weight decay alone moves what is not zero
                assert not torch.equal(p, start[name]), name
            want = 0.5 * start[name] + 0.5 * p.detach()
            np.testing.assert_allclose(tr.ema[name].numpy(), want.numpy(), rtol=1e-6, atol=1e-8)
        else:
            assert torch.equal(p, start[name]) and not p.requires_grad, name
            assert torch.equal(tr.ema[name], start[name])


def test_uint8_wire_is_normalised_and_widened_on_the_device():
    tr = _torch_trainer(seed=0)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(1, 64, 64, 3), dtype=np.uint8)
    batch = tr.prepare_batch({"patch_images": img, "target": np.full((1, 64, 64), 3, np.uint8),
                              "src_tokens": np.ones((1, 4), np.int32)})
    assert batch["patch_images"].dtype == torch.uint8
    assert batch["target"].dtype == batch["src_tokens"].dtype == torch.int64
    got = tr._images(batch["patch_images"])
    np.testing.assert_allclose(got.numpy(), (img.astype(np.float32) / 255.0 - 0.5) / 0.5, atol=1e-6)
    floats = torch.zeros(1, 64, 64, 3)
    assert tr._images(floats) is floats


def test_valid_step_and_supervised_branch():
    cfg = _torch_cfg()
    tr = _torch_trainer(cfg, seed=4)
    batch = train_batch(seed=8)
    out = tr.valid_step(batch)
    assert float(out["loss"]) == float(out["nll_loss"]) and np.isfinite(float(out["loss"]))
    assert tuple(out["area_union"].shape) == (NUM_SEG,)
    sup = _torch_cfg(freeze_entire_resnet=False)
    sup.criterion.unsupervised_segmentation = False
    trs = _torch_trainer(sup, seed=4)
    conv = trs.model.encoder.embed_images.conv1.weight
    start = conv.detach().clone()
    logs = trs.train_step(batch)
    # the same weights and batch: the supervised loss is the monitoring loss
    np.testing.assert_allclose(float(logs["seg_loss"]), float(out["nll_loss"]), rtol=1e-5)
    assert float(logs["imfree_loss"]) == 0.0 and "area_union" not in logs
    assert not torch.equal(conv, start)  # the gradient reached the stem


def test_trainer_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTrainer(_torch_cfg())


@pytest.mark.parametrize("module", ["dropout", "drop_path"])
def test_stochastic_modules_follow_training_flag_and_generator(module):
    mod = Dropout(0.4) if module == "dropout" else DropPath(0.5)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 5, 6)).astype(np.float32))
    assert mod.eval()(x) is x
    mod.train()
    outs = []
    for seed in (0, 0, 1):
        mod.generator = torch.Generator().manual_seed(seed)
        outs.append(mod(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    kept = outs[0] != 0
    scale = 1 / 0.6 if module == "dropout" else 1 / 0.5
    np.testing.assert_allclose(outs[0][kept].numpy(), (x * scale)[kept].numpy(), rtol=1e-6)
    assert 0 < kept.float().mean() < 1
    if module == "drop_path":  # whole samples are dropped
        per_row = kept.reshape(8, -1)
        assert all(bool(r.all()) or not bool(r.any()) for r in per_row)


def test_layer_dropout_is_identity_in_eval_and_repeats_in_training():
    kw = dict(embed_dim=32, ffn_dim=64, num_heads=4)
    plain = EncoderLayer(**kw)
    noisy = EncoderLayer(**kw, dropout=0.2, activation_dropout=0.1, attention_dropout=0.1,
                         drop_path_rate=0.3)
    noisy.load_state_dict(plain.state_dict(), strict=True)  # dropout holds no parameters
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 7, 32)).astype(np.float32))
    bias = torch.zeros(4, 7, 7)
    with torch.no_grad():
        want = plain.eval()(x, None, bias)
        assert torch.equal(noisy.eval()(x, None, bias), want)
        noisy.train()
        outs = []
        for seed in (3, 3, 4):
            set_generator(noisy, torch.Generator().manual_seed(seed))
            outs.append(noisy(x, None, bias))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], want)


def test_training_repeats_bit_for_bit_from_the_seed():
    cfg = lambda: _torch_cfg(dropout=0.1, encoder_drop_path_rate=0.2, decoder_drop_path_rate=0.2)
    batch = train_batch(seed=9)
    runs = []
    for seed in (5, 5, 6):
        c = cfg()
        c.criterion.monitor_real_batch = False
        c.optimization.seed = seed
        tr = _torch_trainer(c, params=_torch_trainer(cfg(), seed=0).model.state_dict())
        rates = [l.drop_path.rate for l in tr.model.encoder.layers]
        assert rates == [0.0, 0.2]  # linspace(0, rate, layers), as the JAX setup
        runs.append([float(tr.train_step(batch)["loss"]) for _ in range(2)])
    assert runs[0] == runs[1] and runs[0] != runs[2]
