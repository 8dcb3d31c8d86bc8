"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

The JAX model is initialised on the CPU, its parameters are perturbed with
numpy (the JAX init leaves relative-position tables at zero and the frozen
BNs at identity, which would hide those paths), and the same numbers are
loaded into the port through ``state_dict_from_jax``.
"""

import jax
import numpy as np
import torch

from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.models.segofa import SegOFA as TorchSegOFA
from ifseg_tpu.config import model_config_for_arch as jax_model_config
from ifseg_tpu.models.segofa import SegOFAVariables

# the tiny serving config of tests/test_serving.py
TINY = dict(
    encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
    encoder_attention_heads=4, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
    decoder_layers=2, decoder_attention_heads=4, resnet_type="resnet50",
    patch_image_size=64, orig_patch_image_size=64, num_seg_tokens=5,
    dtype="float32",
)
JAX_ONLY = dict(dropout=0.0, encoder_drop_path_rate=0.0, decoder_drop_path_rate=0.0)


def perturb(params, seed: int):
    """Give every non-matrix leaf a random value of a plausible scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("rel_pos_table"):
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        if name == "running_var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("running_mean", "bias"):
            return (x + rng.normal(0.0, 0.05, x.shape)).astype(np.float32)
        if name in ("weight", "scale", "c_attn", "w_resid"):
            return (x * rng.uniform(0.8, 1.2, x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def make_pair(seed: int = 0, **overrides):
    """(jax_model, jax_params (numpy), torch_model) with the same weights."""
    kw = dict(TINY, **overrides)
    jmodel, params = SegOFAVariables.init(
        jax_model_config("segofa_tiny", **kw, **JAX_ONLY), jax.random.PRNGKey(seed)
    )
    params = perturb(params, seed)
    tmodel = TorchSegOFA(torch_model_config("segofa_tiny", **kw))
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval()


def torch_tiny(seed: int = 0, **overrides):
    """The port's tiny model alone, with random weights from ``seed``."""
    cfg = torch_model_config("segofa_tiny", **dict(TINY, **overrides))
    return TorchSegOFA(cfg).init(torch.Generator().manual_seed(seed)).eval()


def serving_inputs(seed: int, batch: int = 2, src_len: int = 10, size: int = 64):
    """(src_tokens, images, bos) as numpy; the last row ends in PAD tokens."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 100, size=(batch, src_len)).astype(np.int32)
    src[-1, src_len - 3:] = 1  # PAD: exercises the key-padding mask
    img = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    bos = np.zeros((batch, 1), np.int32)
    return src, img, bos


def class_table(num_seg: int, tmax: int = 3, seed: int = 1):
    """(class_tokens (num_seg+1, tmax), class_lengths): random category-word
    token ids, the trailing row standing for 'unknown'."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 100, size=(num_seg + 1, tmax)).astype(np.int32)
    lengths = rng.integers(1, tmax + 1, size=(num_seg + 1,)).astype(np.int32)
    return tokens, lengths


def train_batch(seed: int, batch: int = 2, src_len: int = 10, size: int = 64, num_seg: int = 5):
    """A full training batch as numpy: real image and labels for the
    monitoring pass, artificial grid and target for the image-free loss.
    Some target cells are 'unknown' (= num_seg) and the last row's prompt ends
    in PAD tokens."""
    rng = np.random.default_rng(seed)
    hw16 = (size // 16) ** 2
    src, img, bos = serving_inputs(seed, batch, src_len, size)
    target = rng.integers(0, num_seg + 1, size=(batch, size, size)).astype(np.int32)
    aux_target = rng.integers(0, num_seg + 1, size=(batch, size, size)).astype(np.int32)
    return {
        "patch_images": img, "src_tokens": src, "bos_tokens": bos, "target": target,
        "downsampled_target": rng.integers(0, num_seg + 1, size=(batch, hw16)).astype(np.int32),
        "aux_grid_ids": rng.integers(0, num_seg, size=(batch, hw16)).astype(np.int32),
        "aux_target": aux_target,
    }
