"""The port's attention and transformer layers against their flax counterparts.

Weights come from one tiny JAX model, carried into the port by
``state_dict_from_jax``; each flax module is applied to the matching subtree
of the JAX params.  Tolerance 2e-5 (fp32 on both sides; the layers differ in
summation order and in the LayerNorm variance formula).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ifseg_tpu.models.attention import MultiheadAttention as JaxMHA
from ifseg_tpu.models.layers import DecoderLayer as JaxDecoderLayer
from ifseg_tpu.models.layers import EncoderLayer as JaxEncoderLayer

from torch_port_utils import make_pair

TOL = 2e-5
B, LQ, LK = 2, 9, 13


@pytest.fixture(scope="module")
def pair():
    jmodel, params, tmodel = make_pair(seed=0)
    return jmodel.cfg, params, tmodel


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(lk):
    m = np.zeros((B, lk), bool)
    m[-1, lk - 3:] = True
    return m


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _layer_kw(cfg):
    return dict(
        attn_scale_factor=cfg.attn_scale_factor, scale_attn=cfg.scale_attn,
        scale_fc=cfg.scale_fc, scale_heads=cfg.scale_heads,
        scale_resids=cfg.scale_resids, activation_fn=cfg.activation_fn,
        dtype=jnp.float32,
    )


@pytest.mark.parametrize("site", ["enc-self", "dec-self-causal", "dec-cross-mask"])
def test_multihead_attention(pair, site):
    cfg, params, tmodel = pair
    d, h = cfg.encoder_embed_dim, cfg.encoder_attention_heads
    query = _rand(1, B, LQ, d)
    if site == "enc-self":
        node, tmod = params["encoder"]["layers_0"]["self_attn"], tmodel.encoder.layers[0].self_attn
        key, lk, causal, mask = None, LQ, False, _mask(LQ)
    elif site == "dec-self-causal":
        node, tmod = params["decoder"]["layers_1"]["self_attn"], tmodel.decoder.layers[1].self_attn
        key, lk, causal, mask = None, LQ, True, None
    else:
        node, tmod = params["decoder"]["layers_0"]["encoder_attn"], tmodel.decoder.layers[0].encoder_attn
        key, lk, causal, mask = _rand(2, B, LK, d), LK, False, _mask(LK)
    bias = _rand(3, h, LQ, lk)

    jmod = JaxMHA(d, h, scale_factor=cfg.attn_scale_factor, scale_heads=cfg.scale_heads)
    want = jmod.apply({"params": node}, _j(query), _j(key), _j(bias), _j(mask), causal)
    with torch.no_grad():
        got = tmod(_t(query), _t(key), bias=_t(bias), key_padding_mask=_t(mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_encoder_layer(pair, with_mask):
    cfg, params, tmodel = pair
    d = cfg.encoder_embed_dim
    x = _rand(4, B, LQ, d)
    bias = _rand(5, cfg.encoder_attention_heads, LQ, LQ)
    mask = _mask(LQ) if with_mask else None
    jmod = JaxEncoderLayer(d, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                           **_layer_kw(cfg))
    want = jmod.apply({"params": params["encoder"]["layers_1"]}, _j(x), _j(mask), _j(bias))
    with torch.no_grad():
        got = tmodel.encoder.layers[1](_t(x), _t(mask), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full-context"])
def test_decoder_layer(pair, causal):
    cfg, params, tmodel = pair
    d, h = cfg.decoder_embed_dim, cfg.decoder_attention_heads
    x = _rand(6, B, LQ, d)
    enc = _rand(7, B, LK, d)
    enc_mask = _mask(LK)
    self_bias = _rand(8, h, LQ, LQ)
    cross_bias = _rand(9, h, LQ, LK)
    jmod = JaxDecoderLayer(d, cfg.decoder_ffn_embed_dim, h, **_layer_kw(cfg))
    want = jmod.apply(
        {"params": params["decoder"]["layers_0"]}, _j(x), _j(enc), _j(enc_mask),
        _j(self_bias), _j(cross_bias), None, causal,
    )
    with torch.no_grad():
        got = tmodel.decoder.layers[0](_t(x), _t(enc), _t(enc_mask), _t(self_bias),
                                       _t(cross_bias), None, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("what", ["adapter", "prompt_kv", "grouped_cross"])
def test_paths_off_the_served_forward_raise(pair, what):
    """The option paths off the served forward, which raised here before the
    port had them, now run and give the flax layer's result: an adapter on
    the FFN output, a prefix prepended in self-attention (with the bias
    given (H, Lq, Lk)), and a query batch twice the key batch (grouped
    cross-attention)."""
    cfg, params, tmodel = pair
    from ifseg_torch.models.layers import EncoderLayer

    d, h = cfg.encoder_embed_dim, cfg.encoder_attention_heads
    x = _rand(10, B, LQ, d)
    if what == "adapter":
        rng = np.random.default_rng(11)
        node = dict(params["encoder"]["layers_0"])
        node["adapter"] = {name: {"kernel": rng.normal(0, 0.1, shape).astype(np.float32),
                                  "bias": rng.normal(0, 0.1, shape[1]).astype(np.float32)}
                           for name, shape in (("down_proj", (d, 8)), ("up_proj", (8, d)))}
        jmod = JaxEncoderLayer(d, cfg.encoder_ffn_embed_dim, h, use_adapter=True, adapter_dim=8,
                               **_layer_kw(cfg))
        bias = _rand(12, h, LQ, LQ)
        want = jmod.apply({"params": node}, _j(x), None, _j(bias))
        tmod = EncoderLayer(d, cfg.encoder_ffn_embed_dim, h, activation_fn=cfg.activation_fn,
                            use_adapter=True, adapter_dim=8).eval()
        state = dict(tmodel.encoder.layers[0].state_dict())
        for name, leaf in node["adapter"].items():
            state[f"adapter.{name}.weight"] = torch.from_numpy(leaf["kernel"].T.copy())
            state[f"adapter.{name}.bias"] = torch.from_numpy(leaf["bias"])
        tmod.load_state_dict(state, strict=True)
        with torch.no_grad():
            got = tmod(_t(x), None, _t(bias))
    else:
        node = params["encoder"]["layers_0"]["self_attn"]
        tmod = tmodel.encoder.layers[0].self_attn
        jmod = JaxMHA(d, h, scale_factor=cfg.attn_scale_factor, scale_heads=cfg.scale_heads)
        if what == "prompt_kv":
            pkv, bias = _rand(13, 2, h, 3, d // h), _rand(14, h, LQ, LQ)
            want = jmod.apply({"params": node}, _j(x), None, _j(bias), None, True,
                              prompt_kv=_j(pkv))
            with torch.no_grad():
                got = tmod(_t(x), bias=_t(bias), causal=True, prompt_kv=_t(pkv))
        else:
            key, mask = _rand(15, 1, LK, d), _mask(LK)[-1:]
            want = jmod.apply({"params": node}, _j(x), _j(key), None, _j(mask))
            with torch.no_grad():
                got = tmod(_t(x), _t(key), key_padding_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
