"""LayerDrop pruning (``checkpoint/convert.py prune_layers``) against the JAX
package's on a tree converted from it, and ``load_model`` of a pruned
checkpoint into a shallower model.  All equal, bit for bit.
"""

import jax
import pytest
import torch

from ifseg_torch.checkpoint.convert import load_model, prune_layers, state_dict_from_jax
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.models.segofa import SegOFA
from ifseg_tpu.checkpoint.convert import prune_layers as jax_prune_layers
from ifseg_tpu.config import model_config_for_arch as jax_model_config
from ifseg_tpu.models.segofa import SegOFAVariables

from torch_port_utils import JAX_ONLY, TINY, perturb

DEEP = dict(TINY, encoder_layers=4, decoder_layers=3)


@pytest.fixture(scope="module")
def jax_params():
    _, params = SegOFAVariables.init(jax_model_config("segofa_tiny", **DEEP, **JAX_ONLY),
                                     jax.random.PRNGKey(0))
    return perturb(params, 0)


@pytest.mark.parametrize("enc,dec", [("0,2", "1"), ("3,1", None), (None, "0,2"), ("2", "2,0,1"),
                                     ("0,1,2,3", "0,1,2")])
def test_prune_layers_matches_jax(jax_params, enc, dec):
    want = state_dict_from_jax(jax_prune_layers(jax_params, enc, dec))
    got = prune_layers(state_dict_from_jax(jax_params), enc, dec)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    n_enc = len(enc.split(",")) if enc else 4
    assert not any(k.startswith(f"encoder.layers.{n_enc}.") for k in got)
    assert sum(k.startswith("encoder.token_rel_pos_table_list.") for k in got) == n_enc


@pytest.mark.parametrize("enc,dec", [("0,4", None), (None, "3"), ("-1", None)])
def test_bad_index_raises_as_in_jax(jax_params, enc, dec):
    with pytest.raises(ValueError, match="out of range") as jax_err:
        jax_prune_layers(jax_params, enc, dec)
    with pytest.raises(ValueError, match="out of range") as err:
        prune_layers(state_dict_from_jax(jax_params), enc, dec)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("kind", ["pt", "directory"])
def test_load_model_prunes_into_a_shallower_model(tmp_path, kind):
    deep = SegOFA(torch_model_config("segofa_tiny", **DEEP)).init(torch.Generator().manual_seed(3))
    sd = deep.state_dict()
    if kind == "pt":
        path = str(tmp_path / "deep.pt")
        torch.save(sd, path)
    else:
        path = tmp_path / "checkpoint_1"
        path.mkdir()
        torch.save(sd, path / "model.pt")
        path = str(path)
    shallow_cfg = torch_model_config("segofa_tiny", **dict(DEEP, encoder_layers=2,
                                                           decoder_layers=1))
    model = load_model(path, shallow_cfg, encoder_layers_to_keep="3,1", decoder_layers_to_keep="2")
    got = model.state_dict()
    for a, b in ((0, 1), (1, 3)):
        for k in sd:
            if k.startswith(f"encoder.layers.{b}."):
                assert torch.equal(got[k.replace(f"layers.{b}.", f"layers.{a}.")], sd[k]), k
        assert torch.equal(got[f"encoder.image_rel_pos_table_list.{a}.weight"],
                           sd[f"encoder.image_rel_pos_table_list.{b}.weight"])
    for k in sd:
        if k.startswith("decoder.layers.2."):
            assert torch.equal(got[k.replace("layers.2.", "layers.0.")], sd[k]), k
    assert torch.equal(got["encoder.layer_norm.weight"], sd["encoder.layer_norm.weight"])
    unpruned = "decoder.layers.0.fc1.weight"
    if kind == "directory":  # a port checkpoint loads strictly: unpruned, it does not fit
        with pytest.raises(RuntimeError):
            load_model(path, shallow_cfg)
    else:  # a .pt file is reconciled: unpruned, the shallow model takes the first layers
        assert torch.equal(load_model(path, shallow_cfg).state_dict()[unpruned], sd[unpruned])
