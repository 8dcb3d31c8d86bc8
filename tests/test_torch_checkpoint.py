"""Weights carried into the port: ``state_dict_from_jax`` and
``load_torch_checkpoint``.

The port's parameter names are the reference torch names, so the converted
JAX tree must load strictly, with no key missing and none left over, and a
fairseq-style ``.pt`` envelope must unwrap to the same state dict.
"""

import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import load_torch_checkpoint, state_dict_from_jax
from ifseg_torch.config import model_config_for_arch
from ifseg_torch.models.segofa import SegOFA

from torch_port_utils import make_pair, torch_tiny


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=2)


def test_converted_jax_tree_loads_strictly(pair):
    jmodel, params, _ = pair
    sd = state_dict_from_jax(params)
    fresh = SegOFA(model_config_for_arch("segofa_tiny", **_tiny_kwargs(jmodel.cfg)))
    result = fresh.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(fresh.state_dict())


def test_converted_values_and_layouts(pair):
    _, params, tmodel = pair
    sd = tmodel.state_dict()
    enc = params["encoder"]
    np.testing.assert_array_equal(
        sd["encoder.layers.0.self_attn.q_proj.weight"].numpy(),
        np.asarray(enc["layers_0"]["self_attn"]["q_proj"]["kernel"]).T,
    )
    np.testing.assert_array_equal(
        sd["encoder.embed_images.layer3.1.conv2.weight"].numpy(),
        np.asarray(enc["embed_images"]["layer3_1"]["conv2"]["kernel"]).transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["encoder.token_rel_pos_table_list.1.weight"].numpy(),
        np.asarray(enc["token_rel_pos_table"])[1],
    )
    np.testing.assert_array_equal(
        sd["decoder.seg_embed_tokens.weight"].numpy(),
        np.asarray(params["decoder"]["seg_embed_tokens"]),
    )
    # held for strict loading, never created by the JAX model: zeros
    assert not sd["decoder.embed_image_positions.weight"].any()
    # one shared token embedding under both reference names
    assert tmodel.encoder.embed_tokens is tmodel.decoder.embed_tokens
    assert torch.equal(sd["encoder.embed_tokens.weight"], sd["decoder.embed_tokens.weight"])


@pytest.mark.parametrize("envelope", [True, False], ids=["fairseq-envelope", "bare"])
def test_load_torch_checkpoint(tmp_path, envelope):
    model = torch_tiny(seed=3)
    sd = model.state_dict()
    obj = {"model": sd, "args": None, "optimizer_history": []} if envelope else sd
    path = tmp_path / "ckpt.pt"
    torch.save(obj, path)
    loaded = load_torch_checkpoint(str(path))
    other = torch_tiny(seed=4)
    result = other.load_state_dict(loaded, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_seeded_init_is_reproducible():
    a, b = torch_tiny(seed=5).state_dict(), torch_tiny(seed=5).state_dict()
    c = torch_tiny(seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layers.0.fc1.weight"], c["encoder.layers.0.fc1.weight"])


def _tiny_kwargs(cfg):
    keys = ("encoder_embed_dim", "encoder_ffn_embed_dim", "encoder_layers",
            "encoder_attention_heads", "decoder_embed_dim", "decoder_ffn_embed_dim",
            "decoder_layers", "decoder_attention_heads", "resnet_type",
            "patch_image_size", "orig_patch_image_size", "num_seg_tokens", "dtype")
    return {k: getattr(cfg, k) for k in keys}
