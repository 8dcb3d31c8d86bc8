"""The port's schedule, Adam, clipping and freeze mask against the JAX
package's ``train/optim.py`` (CPU, fp32).

Tolerances: schedule values 1e-6 relative (fp32 cosine in JAX, double here);
Adam parameters after three updates 2e-6 relative, 2e-7 absolute (the same
fp32 arithmetic, a few ulps apart where XLA fuses differently); clipped gradients 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.train import optim as to
from ifseg_tpu.train import optim as jo

from torch_port_utils import make_pair


@pytest.mark.parametrize("warmup_ratio", [0.0, 0.2], ids=["no-warmup", "warmup"])
def test_cosine_schedule_matches_jax(warmup_ratio):
    total = 50
    want = jo.cosine_schedule(5e-5, total, warmup_ratio=warmup_ratio)
    got = to.cosine_schedule(5e-5, total, warmup_ratio=warmup_ratio)
    for step in (0, 1, 5, 9, 10, 11, 25, 49, 50, 80):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")


def test_three_adam_updates_match_jax():
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes] for _ in range(3)]
    sched_j = jo.cosine_schedule(1e-2, 10)
    tx = jo.fairseq_adam(sched_j, 0.9, 0.999, 1e-8, weight_decay=0.1)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt = to.fairseq_adam(tp, to.cosine_schedule(1e-2, 10), 0.9, 0.999, 1e-8, weight_decay=0.1)
    for step in range(3):
        upd, state = tx.update([jnp.asarray(g) for g in grads[step]], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        opt.step([torch.from_numpy(g) for g in grads[step]])
        assert opt.count == int(state.count) == step + 1
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-7)
        for got, want in zip(opt.mu + opt.nu, list(state.mu) + list(state.nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below-clip", "above-clip"])
def test_clip_by_global_norm_matches_jax(scale):
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in [(6, 3), (9,)]]
    want, want_norm = jo.clip_by_global_norm([jnp.asarray(g) for g in grads], 1.0)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    got_norm = to.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    for g, w in zip(tg, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


FREEZE_CASES = {
    "reference": {},
    "all-trainable": dict(freeze_encoder_embedding=False, freeze_decoder_embedding=False,
                          freeze_seg_embedding=False, freeze_entire_resnet=False),
    "encoder-layer-0": dict(freeze_encoder_transformer_layers=1),
    "encoder-stack": dict(freeze_encoder_transformer=True, freeze_seg_embedding=False),
}


@pytest.mark.parametrize("case", list(FREEZE_CASES))
def test_freeze_mask_matches_jax_through_the_converter(case):
    """The JAX mask, written as a 1.0 / 0.0 tree and carried through the
    converter's names, gives the port's trainable set."""
    jmodel, params, tmodel = make_pair(seed=0, **FREEZE_CASES[case])
    jmask = jo.freeze_mask(params, jmodel.cfg)
    as_numbers = jax.tree_util.tree_map(
        lambda t, p: np.full(np.shape(p), 1.0 if t else 0.0, np.float32), jmask, params)
    want = state_dict_from_jax(as_numbers)
    got = to.freeze_mask(tmodel, tmodel.cfg)
    assert set(got) == {n for n, _ in tmodel.named_parameters()}
    for name, trainable in got.items():
        if name == "decoder.embed_image_positions.weight":
            continue  # only the port holds this table; no JAX path reads it
        assert bool(want[name].min()) == bool(want[name].max()) == trainable, name
    # the seg head is not caught by the embedding freeze
    if case == "all-trainable":
        assert all(got.values())
    if case == "reference":
        assert not got["encoder.embed_tokens.weight"]
        assert not got["decoder.seg_embed_tokens.weight"]
        assert got["decoder.layers.0.fc1.weight"] and got["encoder.image_proj.weight"]


def test_build_optimizer_refuses_what_is_not_ported():
    from ifseg_torch.config import OptimizationConfig

    _, _, tmodel = make_pair(seed=0)
    with pytest.raises(NotImplementedError, match="scheduler"):
        to.build_optimizer(tmodel, tmodel.cfg, OptimizationConfig(lr_scheduler="inverse_sqrt"), 10)
    with pytest.raises(NotImplementedError, match="optimizer"):
        to.build_optimizer(tmodel, tmodel.cfg, OptimizationConfig(optimizer="lamb"), 10)
