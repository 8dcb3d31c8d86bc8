"""The port against the JAX package at OFA-Base's widths (d 768, 12 heads of
64, FFN 3,072, ResNet-101), cut to 2 + 2 layers and a 128-pixel image, with
perturbed seed weights (CPU, fp32): the width users run, where the other
parity tests build the tiny config.

- Served logits: 2e-4 relative and absolute, ``tests/test_torch_serving.py``'s
  tolerance.
- One ``Trainer.train_step`` with ``checkpoint_activations=True`` under
  save-attn, from the same weights and Adam moments: the tolerances of
  ``tests/test_torch_trainer.py`` (losses 2e-5, gnorm 1e-3, each
  parameter's delta within 2e-3 of JAX's in norm).
"""

import jax.numpy as jnp
import numpy as np
import torch

from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.eval.serving import SegServer as TorchSegServer
from ifseg_tpu.eval.serving import SegServer as JaxSegServer

from test_torch_remat import step_against_jax
from torch_port_utils import make_pair, serving_inputs

NUM_SEG = 5
BASE = dict(encoder_layers=2, decoder_layers=2, patch_image_size=128, orig_patch_image_size=128,
            num_seg_tokens=NUM_SEG, dtype="float32")  # segofa_base's widths, 2 + 2 layers


def _widths_of(arch):
    """The widths of ``arch`` as ``make_pair`` overrides (it starts from segofa_tiny)."""
    cfg = torch_model_config(arch)
    return {k: getattr(cfg, k) for k in (
        "encoder_embed_dim", "encoder_ffn_embed_dim", "encoder_attention_heads",
        "decoder_embed_dim", "decoder_ffn_embed_dim", "decoder_attention_heads", "resnet_type")}


def test_base_width_served_logits_match_jax():
    jmodel, params, tmodel = make_pair(seed=0, **{**_widths_of("segofa_base"), **BASE})
    assert tmodel.cfg.encoder_embed_dim == 768 and tmodel.cfg.resnet_type == "resnet101"
    src, img, bos = serving_inputs(seed=1, size=128)
    want = np.asarray(JaxSegServer(jmodel, params, src_len=10)(
        jnp.asarray(src), jnp.asarray(img), jnp.asarray(bos)))
    got = TorchSegServer(tmodel, src_len=10, device="cpu")(
        torch.from_numpy(src), torch.from_numpy(img), torch.from_numpy(bos))
    assert tuple(got.shape) == (2, 1 + 8 * 8, NUM_SEG)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_base_width_checkpointed_train_step_matches_jax():
    step_against_jax(dict(_widths_of("segofa_base"), encoder_layers=2, decoder_layers=2,
                          dtype="float32", checkpoint_activations=True, remat_policy="save-attn"),
                     arch="segofa_base", size=128)
