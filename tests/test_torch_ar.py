"""The port's autoregressive path against the JAX package's (CPU, fp32):
``Decoder.decode_ar`` (both embed modes; with decoder prompts in
tests/test_torch_adapters_prompt.py), the
KV-cached ``ar_step`` step by step, cached against uncached, and
``build_generator`` (cached, uncached, an ensemble) against the JAX
``build_generator``.  Logits within 2e-4; generated tokens equal, scores
within 1e-5.  Mirrors tests/test_ar_decode.py and tests/test_ar_cache.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.models.ar_cache import ar_step as t_ar_step, init_ar_cache as t_init
from ifseg_torch.models.segofa import build_generator as t_build
from ifseg_tpu.models.ar_cache import ar_step as j_ar_step, init_ar_cache as j_init
from ifseg_tpu.models.segofa import build_generator as j_build

from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.models.segofa import SegOFA as TorchSegOFA

from torch_port_utils import class_table, make_pair, serving_inputs, torch_tiny

TOL = 2e-4
LMAX = 6


def _encode_both(jmodel, params, tmodel, seed=0, batch=2):
    """The image-free encoder output of both (no ResNet: cheap on the CPU)."""
    src, _, _ = serving_inputs(seed, batch=batch)
    grid = np.random.default_rng(seed).integers(0, 5, size=(batch, 16)).astype(np.int32)
    tokens, lengths = class_table(5)
    jenc = jmodel.apply({"params": params}, method=lambda m, *a: m.encoder.encode_artificial(*a),
                        *(jnp.asarray(x) for x in (src, grid, tokens, lengths)))
    with torch.no_grad():
        tenc = tmodel.encoder.encode_artificial(
            *(torch.from_numpy(x).long() for x in (src, grid, tokens, lengths)))
    return jenc, tenc


def _prev(seed=1, batch=2, length=LMAX, num_seg=5):
    prev = np.random.default_rng(seed).integers(0, num_seg, size=(batch, length)).astype(np.int32)
    prev[:, 0] = 0  # bos
    return prev


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0)


@pytest.fixture(scope="module")
def encoded(pair):
    return _encode_both(*pair)


@pytest.mark.parametrize("embed_mode", ["seg", "vocab"])
def test_decode_ar_matches_jax(pair, encoded, embed_mode):
    jmodel, params, tmodel = pair
    jenc, tenc = encoded
    prev = _prev()
    want = jmodel.apply({"params": params}, jnp.asarray(prev), jenc,
                        method=lambda m, t, e: m.decoder.decode_ar(t, e, embed_mode=embed_mode))
    with torch.no_grad():
        got = tmodel.decoder.decode_ar(torch.from_numpy(prev).long(), tenc, embed_mode)
    assert tuple(got.shape) == (2, LMAX, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_ar_step_matches_jax_and_the_recompute(pair, encoded):
    jmodel, params, tmodel = pair
    jenc, tenc = encoded
    prev = _prev(seed=5)
    tprev = torch.from_numpy(prev).long()
    with torch.no_grad():
        full = tmodel.decoder.decode_ar(tprev, tenc).numpy()
    cfg = jmodel.cfg
    jcache = j_init(cfg, params, jenc, bsz=2, max_len=LMAX)
    tcache = t_init(tmodel, tenc, 2, LMAX)
    for step in range(LMAX):
        want, jcache = j_ar_step(cfg, params, jcache, jnp.asarray(prev), jnp.int32(step))
        got, tcache = t_ar_step(tmodel, tcache, tprev, step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got.numpy(), full[:, step], atol=3e-4, rtol=3e-4)


def test_kv_cache_refuses_what_the_jax_one_refuses():
    tmodel = torch_tiny(0, decoder_prompt=True, decoder_prompt_length=2)
    with pytest.raises(NotImplementedError, match="decoder_prompt"):
        t_init(tmodel, {"encoder_out": torch.zeros(1, 3, 32),
                        "position_embeddings": torch.zeros(3, 32),
                        "encoder_padding_mask": torch.zeros(1, 3, dtype=torch.bool)}, 1, 4)
    with pytest.raises(ValueError, match="1024"):
        t_build(tmodel, {"encoder_out": torch.zeros(1, 3, 32)}, max_len=1023, min_len=1023,
                use_kv_cache=False)


@pytest.mark.parametrize("cached", [True, False], ids=["kv_cache", "recompute"])
def test_build_generator_matches_jax(pair, encoded, cached):
    jmodel, params, tmodel = pair
    jenc, tenc = encoded
    kw = dict(beam=3, max_len=4, min_len=4, use_kv_cache=cached)
    jgen = j_build(jmodel, params, jenc, **kw)
    want = jgen(bsz=2, cache=getattr(jgen, "initial_cache", ()))
    tgen = t_build(tmodel, tenc, **kw)
    got = tgen(2, tgen.initial_cache)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=1e-5)


def test_generator_cached_equals_recompute_and_ensemble_matches_jax(pair):
    jmodel, params, tmodel = pair
    jenc, tenc = _encode_both(jmodel, params, tmodel, seed=7, batch=1)
    kw = dict(beam=2, max_len=4, min_len=4)
    cached = t_build(tmodel, tenc, use_kv_cache=True, **kw)
    recompute = t_build(tmodel, tenc, use_kv_cache=False, **kw)
    a, b = cached(1, cached.initial_cache), recompute(1, ())
    np.testing.assert_array_equal(a.tokens[0, 0].numpy(), b.tokens[0, 0].numpy())
    np.testing.assert_allclose(a.scores[0, 0].item(), b.scores[0, 0].item(), atol=1e-4)

    # an ensemble of two weight sets, averaged in probability space: the
    # second is the first with noise, carried into the port as the first was
    rng = np.random.default_rng(1)
    params2 = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)
    tmodel2 = TorchSegOFA(tmodel.cfg)
    tmodel2.load_state_dict(state_dict_from_jax(params2), strict=True)
    tmodel2.eval()
    jgen = j_build(jmodel, [params, params2], jenc, **kw)
    want = jgen(bsz=1, cache=jgen.initial_cache)
    tgen = t_build([tmodel, tmodel2], tenc, **kw)
    got = tgen(1, tgen.initial_cache)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=1e-5)
