"""Loading a pretrained ``ofa_base.pt``-shaped file into the port, against
the JAX package's converter on the same file.

The file is the JAX package's ``fabricate_ofa_base_checkpoint`` at the tiny
width: the token embedding one row short of the target vocab and no
seg-specific tensors.  Every tensor the JAX ``convert_torch_state_dict``
loads from it (taken to the port's names by ``state_dict_from_jax``) equals
the port's, the appended vocab row included (both draw it from
``np.random.default_rng(0)``), and both keep their fresh initialisation for
the same tensors.  Values are copied, never computed: equal, not close.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint import convert as tc
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.models.segofa import SegOFA
from ifseg_tpu.checkpoint import convert as jc
from ifseg_tpu.config import model_config_for_arch as jax_model_config
from ifseg_tpu.models.segofa import SegOFAVariables

from torch_port_utils import JAX_ONLY, TINY

# the reference decoder's image position table: the port holds it (no path
# reads it), the JAX model never creates it, so only the port backfills it
PORT_ONLY = {"decoder.embed_image_positions.weight"}


@pytest.fixture(scope="module")
def cfgs():
    return (jax_model_config("segofa_tiny", **TINY, **JAX_ONLY),
            torch_model_config("segofa_tiny", **TINY))


@pytest.fixture(scope="module")
def ofa_file(tmp_path_factory, cfgs):
    path = str(tmp_path_factory.mktemp("ofa") / "ofa_base.pt")
    jc.fabricate_ofa_base_checkpoint(path, cfgs[0], seed=0)
    return path


def _fresh_port(cfg, seed):
    return SegOFA(cfg).init(torch.Generator().manual_seed(seed))


def test_loaded_tensors_equal_jax_convert(ofa_file, cfgs):
    jcfg, tcfg = cfgs
    vocab = tcfg.vocab_size
    assert jcfg.vocab_size == vocab
    _, jfresh = SegOFAVariables.init(jcfg, jax.random.PRNGKey(1))
    jtree = jc.convert_torch_state_dict(jc.load_torch_checkpoint(ofa_file), vocab,
                                        jax.device_get(jfresh))
    want = tc.state_dict_from_jax(jtree)
    want_fresh = tc.state_dict_from_jax(jax.device_get(jfresh))

    file_sd = tc.load_torch_checkpoint(ofa_file)
    assert file_sd["encoder.embed_tokens.weight"].shape[0] == vocab - 1
    ref = _fresh_port(tcfg, 5).state_dict()
    got = tc.convert_torch_state_dict(file_sd, vocab, ref)
    assert set(got) == set(ref)

    def from_file(k, sd):
        f = file_sd.get(k)
        if f is None:
            return False
        if k.endswith("embed_tokens.weight"):
            return torch.equal(sd[k][:-1], f)
        return f.shape == sd[k].shape and torch.equal(sd[k], f)

    loaded_got = {k for k in got if from_file(k, got)}
    loaded_want = {k for k in want if from_file(k, want)}
    assert loaded_got == loaded_want and loaded_got
    for k in loaded_got:
        assert torch.equal(got[k], want[k]), k
    # the appended row: the seed-0 draw of both packages
    row = np.random.default_rng(0).normal(0.0, tcfg.encoder_embed_dim ** -0.5,
                                          (1, tcfg.encoder_embed_dim)).astype(np.float32)
    for k in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight"):
        np.testing.assert_array_equal(got[k][-1:].numpy(), row)
    # the rest is each side's fresh init, and it is the same set of tensors
    backfilled_got = set(got) - loaded_got
    backfilled_want = set(want) - loaded_want
    assert backfilled_got == backfilled_want | PORT_ONLY
    assert {k for k in backfilled_got if any(s in k for s in tc._SEG_ONLY_KEYS)} == \
        backfilled_got - PORT_ONLY
    for k in backfilled_got:
        assert got[k] is ref[k], k
    for k in backfilled_want:
        assert torch.equal(want[k], want_fresh[k]), k
    # strictly loadable
    model = _fresh_port(tcfg, 6)
    result = model.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_load_model(ofa_file, cfgs):
    _, tcfg = cfgs
    model = tc.load_model(ofa_file, tcfg)
    fresh = _fresh_port(tcfg, 0).state_dict()  # load_model starts from seed 0
    want = tc.convert_torch_state_dict(tc.load_torch_checkpoint(ofa_file), tcfg.vocab_size, fresh)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert model.encoder.embed_tokens is model.decoder.embed_tokens
    with pytest.raises(ValueError, match="neither a .pt file nor a checkpoint directory"):
        tc.load_model(ofa_file[:-3], tcfg)


def test_vocab_surgery_truncates_a_trailing_mask_row_as_jax_does():
    rng = np.random.default_rng(2)
    target, d = 20, 8
    arrays = {k: rng.normal(size=(target + 1, d)).astype(np.float32)
              for k in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight",
                        "decoder.output_projection.weight")}
    arrays["encoder.layers.0.fc1.weight"] = rng.normal(size=(4, d)).astype(np.float32)
    want = jc._vocab_surgery(dict(arrays), target)
    got = tc._vocab_surgery({k: torch.from_numpy(v) for k, v in arrays.items()}, target)
    for k in arrays:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert got["encoder.embed_tokens.weight"].shape == (target, d)
    # rows missing: the same draws, for any count
    short = {"encoder.embed_tokens.weight": arrays["encoder.embed_tokens.weight"][:15]}
    want = jc._vocab_surgery(dict(short), target)
    got = tc._vocab_surgery({k: torch.from_numpy(v) for k, v in short.items()}, target)
    np.testing.assert_array_equal(got["encoder.embed_tokens.weight"].numpy(),
                                  want["encoder.embed_tokens.weight"])


def test_shape_mismatch_and_unused_keys_keep_the_fresh_init(ofa_file, cfgs, caplog):
    _, tcfg = cfgs
    sd = tc.load_torch_checkpoint(ofa_file)
    sd["encoder.embed_positions.weight"] = sd["encoder.embed_positions.weight"][:-3]
    sd["encoder.version"] = torch.ones(1)
    ref = _fresh_port(tcfg, 7).state_dict()
    with caplog.at_level(logging.INFO, logger="ifseg_torch.checkpoint.convert"):
        got = tc.convert_torch_state_dict(sd, tcfg.vocab_size, ref)
    assert got["encoder.embed_positions.weight"] is ref["encoder.embed_positions.weight"]
    assert "encoder.version" not in got
    text = caplog.text
    assert "shape mismatch encoder.embed_positions.weight" in text and "encoder.version" in text
    _fresh_port(tcfg, 8).load_state_dict(got, strict=True)


def test_port_fabricated_file_loads_through_the_surgery(tmp_path, cfgs):
    _, tcfg = cfgs
    path = str(tmp_path / "ofa.pt")
    tc.fabricate_ofa_base_checkpoint(path, tcfg, seed=3, device="cpu")
    file_sd = tc.load_torch_checkpoint(path)
    assert not any(s in k for k in file_sd for s in tc._SEG_ONLY_KEYS)
    assert file_sd["encoder.embed_tokens.weight"].shape[0] == tcfg.vocab_size - 1
    source = _fresh_port(tcfg, 3).state_dict()  # what the file was made from
    model = tc.load_model(path, tcfg).state_dict()
    fresh = _fresh_port(tcfg, 0).state_dict()
    for k, v in model.items():
        if any(s in k for s in tc._SEG_ONLY_KEYS):
            assert torch.equal(v, fresh[k]), k
        elif k.endswith("embed_tokens.weight"):
            assert torch.equal(v[:-1], source[k][:-1]), k
        else:
            assert torch.equal(v, source[k]), k
