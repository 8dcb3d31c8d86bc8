"""The port's image-free training forward and its gradients against the JAX
model (CPU, fp32, dropout 0).

The same weights (``make_pair``) and the same numpy inputs go through
``SegOFA.__call__`` with the ``aux_*`` inputs on both sides.  Logits 2e-4
(the serving parity tolerance).  Gradients of the image-free loss: for every
tensor, ||g_port − g_jax|| ≤ 1e-3 · ||g_jax|| + 1e-7; the port's gradient
comes through the explicit attention backward (the wiring the card uses),
JAX's through ``jax.grad``.  The absolute 1e-7 is the fp32 noise floor: the
key-side position biases have a gradient that is zero in exact arithmetic
(softmax does not see a shift that is constant along the keys), and both
sides return rounding noise of about 1e-8 for them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.train.criterion import compute_imfree_loss as t_imfree
from ifseg_tpu.train.criterion import compute_imfree_loss as j_imfree

from torch_port_utils import class_table, make_pair, train_batch

NUM_SEG, HW = 5, 4


def _jax_aux(jmodel, params, batch, tokens, lengths, fca=False):
    _, extra = jmodel.apply(
        {"params": params}, aux_grid_ids=jnp.asarray(batch["aux_grid_ids"]),
        aux_src_tokens=jnp.asarray(batch["src_tokens"]), bos_tokens=jnp.asarray(batch["bos_tokens"]),
        class_tokens=jnp.asarray(tokens), class_lengths=jnp.asarray(lengths),
        full_context_alignment=fca, deterministic=True,
    )
    return extra["aux_output"]


def _torch_aux(tmodel, batch, tokens, lengths, fca=False):
    t = lambda x: torch.from_numpy(np.asarray(x)).long()
    _, extra = tmodel(
        aux_grid_ids=t(batch["aux_grid_ids"]), aux_src_tokens=t(batch["src_tokens"]),
        bos_tokens=t(batch["bos_tokens"]), class_tokens=t(tokens), class_lengths=t(lengths),
        full_context_alignment=fca,
    )
    return extra["aux_output"]


@pytest.mark.parametrize("fca", [False, True], ids=["causal", "full-context"])
def test_artificial_forward_logits_match_jax(fca):
    jmodel, params, tmodel = make_pair(seed=0)
    tokens, lengths = class_table(NUM_SEG)
    batch = train_batch(seed=1)
    want = np.asarray(_jax_aux(jmodel, params, batch, tokens, lengths, fca))
    with torch.no_grad():
        got_infer = _torch_aux(tmodel, batch, tokens, lengths, fca)
    got = _torch_aux(tmodel, batch, tokens, lengths, fca)  # the stats path
    assert got.requires_grad and tuple(got.shape) == (2, 1 + HW * HW, NUM_SEG)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_infer.numpy(), want, atol=2e-4, rtol=2e-4)


def test_real_image_forward_matches_jax():
    """``encode`` + decoder with the biases built in the graph (the
    monitoring and supervised path), interpolated image bias included."""
    jmodel, params, tmodel = make_pair(seed=0, orig_patch_image_size=32)
    batch = train_batch(seed=2)
    want, _ = jmodel.apply(
        {"params": params}, src_tokens=jnp.asarray(batch["src_tokens"]),
        patch_images=jnp.asarray(batch["patch_images"]),
        bos_tokens=jnp.asarray(batch["bos_tokens"]), deterministic=True,
    )
    with torch.no_grad():
        got, extra = tmodel(
            src_tokens=torch.from_numpy(batch["src_tokens"]).long(),
            patch_images=torch.from_numpy(batch["patch_images"]),
            bos_tokens=torch.from_numpy(batch["bos_tokens"]).long(),
        )
    assert extra["encoder_returns"]["image_embed_shape"] == (HW, HW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_imfree_loss_gradients_match_jax_grad():
    jmodel, params, tmodel = make_pair(seed=0)
    tokens, lengths = class_table(NUM_SEG)
    batch = train_batch(seed=3)
    target = batch["aux_target"]

    def jloss(p):
        logits = _jax_aux(jmodel, p, batch, tokens, lengths)
        return j_imfree(logits, jnp.asarray(target), NUM_SEG, (HW, HW), 0.0)

    jl, jgrads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
    want = state_dict_from_jax(jax.device_get(jgrads))

    for p in tmodel.parameters():
        p.requires_grad_(True)
    loss = t_imfree(_torch_aux(tmodel, batch, tokens, lengths),
                    torch.from_numpy(target).long(), NUM_SEG, (HW, HW), 0.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)

    checked = 0
    for name, p in tmodel.named_parameters():
        ref = want[name].numpy()
        ref_norm = np.linalg.norm(ref)
        if p.grad is None:
            assert ref_norm == 0.0, f"{name}: the port gives no gradient, JAX does"
            continue
        err = np.linalg.norm(p.grad.numpy() - ref)
        assert err <= 1e-3 * ref_norm + 1e-7, f"{name}: {err} vs norm {ref_norm}"
        checked += ref_norm > 1e-6
    # reached only through dbias: the three kinds of relative-position table
    # that the image-free path reads and the decoder's cross-position linears
    for name in ("encoder.token_rel_pos_table_list.0.weight",
                 "encoder.image_rel_pos_table_list.1.weight",
                 "decoder.seg_rel_pos_table_list.0.weight",
                 "decoder.cross_pos_q_linear.weight", "decoder.cross_pos_k_linear.weight",
                 "encoder.pos_q_linear.weight", "decoder.self_pos_k_linear.weight"):
        assert np.linalg.norm(want[name].numpy()) > 0, name
        assert tmodel.get_parameter(name).grad is not None, name
    assert checked > 100
