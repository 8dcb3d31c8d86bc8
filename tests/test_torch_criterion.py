"""The port's criterion against the JAX package's (CPU, fp32 logits).

Tolerances: the losses 2e-5 relative (both sides upsample bf16-rounded
operands with fp32 accumulation and reduce in fp32; they differ in summation
order); the confusion areas are counts and must be equal; the seg-embedding
init 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ifseg_torch.train import criterion as tc
from ifseg_tpu.train import criterion as jc

from torch_port_utils import class_table, make_pair

B, HW, S, C = 2, 4, 64, 5


def _logits_and_targets(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, 1 + HW * HW, C)).astype(np.float32) * 2.0
    target = rng.integers(0, C + 1, size=(B, S, S)).astype(np.int32)  # C = unknown
    down = rng.integers(0, C + 1, size=(B, HW * HW)).astype(np.int32)
    return logits, target, down


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1], ids=["plain", "smoothed"])
def test_imfree_loss_matches_jax(label_smoothing):
    logits, target, _ = _logits_and_targets(0)
    want = float(jc.compute_imfree_loss(jnp.asarray(logits), jnp.asarray(target), C, (HW, HW),
                                        label_smoothing))
    got = tc.compute_imfree_loss(torch.from_numpy(logits), torch.from_numpy(target).long(), C,
                                 (HW, HW), label_smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=2e-5)


def test_imfree_loss_gradient_matches_jax():
    """d loss / d logits through the checkpointed row chunks: 1e-4 of the
    gradient's norm."""
    import jax

    logits, target, _ = _logits_and_targets(1)
    want = np.asarray(jax.grad(
        lambda z: jc.compute_imfree_loss(z, jnp.asarray(target), C, (HW, HW), 0.1)
    )(jnp.asarray(logits)))
    z = torch.from_numpy(logits).requires_grad_(True)
    tc.compute_imfree_loss(z, torch.from_numpy(target).long(), C, (HW, HW), 0.1).backward()
    err = np.linalg.norm(z.grad.numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-4, err
    assert np.all(z.grad.numpy()[:, HW * HW:] == 0)  # the eos slot takes no gradient


def test_all_unknown_target_gives_zero_loss():
    logits, target, _ = _logits_and_targets(2)
    target[:] = C
    got = tc.compute_imfree_loss(torch.from_numpy(logits), torch.from_numpy(target).long(), C,
                                 (HW, HW))
    assert float(got) == 0.0


def test_monitor_outputs_match_jax():
    logits, target, down = _logits_and_targets(3)
    want = jc.compute_monitor_outputs(jnp.asarray(logits), jnp.asarray(target),
                                      jnp.asarray(down), C, (HW, HW), 0.0)
    got = tc.compute_monitor_outputs(torch.from_numpy(logits), torch.from_numpy(target).long(),
                                     torch.from_numpy(down).long(), C, (HW, HW), 0.0)
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got["nll_loss"]), float(want["nll_loss"]), rtol=2e-5)
    for key in want:
        if key == "nll_loss":
            continue
        assert tuple(got[key].shape) == (C,)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_confusion_areas_match_jax():
    from ifseg_torch.ops.histogram import class_histogram, confusion_areas
    from ifseg_tpu.ops import histogram as jh

    rng = np.random.default_rng(4)
    pred = rng.integers(0, C, size=(3, 50)).astype(np.int32)
    target = rng.integers(0, C + 1, size=(3, 50)).astype(np.int32)
    valid = target != C
    want = jh.confusion_areas(jnp.asarray(pred), jnp.asarray(target), C, jnp.asarray(valid))
    got = confusion_areas(torch.from_numpy(pred).long(), torch.from_numpy(target).long(), C,
                          torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids = np.array([-1, 0, 2, 2, 7, 4], np.int32)  # ids outside [0, C) are dropped
    np.testing.assert_array_equal(
        class_histogram(torch.from_numpy(ids).long(), C).numpy(),
        np.asarray(jh.class_histogram(jnp.asarray(ids), C)),
    )


def test_init_seg_embeddings_matches_jax():
    _, params, tmodel = make_pair(seed=0)
    tokens, lengths = class_table(C)
    want = jc.init_seg_embeddings(params, tokens, lengths, C)["decoder"]["seg_embed_tokens"]
    tc.init_seg_embeddings(tmodel, tokens, lengths, C)
    got = tmodel.decoder.seg_embed_tokens.weight.detach().numpy()
    assert got.shape == (C, 32)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)
