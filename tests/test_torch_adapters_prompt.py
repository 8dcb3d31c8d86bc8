"""Adapters, prefix tuning, grouped cross-attention and 4-D biases in the
port against the JAX package (CPU, fp32); mirrors tests/test_adapters_prompt.py.

- the adapter's math and the prompt encoder's shapes, with and without the
  projection, on the JAX modules' own parameters;
- attention with ``prompt_kv`` (causal or not, with a key mask), grouped
  cross-attention and a (B, H, Lq, Lk) bias against
  ``ifseg_tpu.models.attention``, 2e-4;
- the tiny SegOFA with encoder and decoder prompts and adapters: the
  image-free loss within 2e-5 and every gradient within 2e-4 · its norm of
  ``jax.grad`` (the port's through the attention backward that the card
  runs);
- ``freeze_mask`` equal to the JAX mask leaf by leaf (through
  ``jax_paths``) for the default, BitFit, prompt, prompt + adapter and
  adapter configs, and the trainable count of prefix tuning;
- ``encode_served`` / ``decode_served`` ignore the prefixes, as the JAX
  ones do;
- a reference ``.pt`` carrying prompt or adapter tensors: loaded by
  ``load_model`` where the config has the option, refused where not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.checkpoint.convert import load_model, state_dict_from_jax
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.eval.serving import SegServer as TorchSegServer
from ifseg_torch.models.attention import MultiheadAttention as TorchMHA
from ifseg_torch.models.layers import Adapter as TorchAdapter, PromptEncoder as TorchPrompt
from ifseg_torch.train import optim as toptim
from ifseg_torch.train.criterion import compute_imfree_loss as t_imfree
from ifseg_tpu.config import model_config_for_arch as jax_model_config
from ifseg_tpu.eval.serving import SegServer as JaxSegServer
from ifseg_tpu.models.attention import MultiheadAttention as JaxMHA
from ifseg_tpu.models.layers import Adapter as JaxAdapter, PromptEncoder as JaxPrompt
from ifseg_tpu.train.criterion import compute_imfree_loss as j_imfree
from ifseg_tpu.train.optim import freeze_mask as j_freeze_mask

from torch_port_utils import TINY, class_table, make_pair, serving_inputs, train_batch

TOL = 2e-4
NUM_SEG, HW = 5, 4
OPTIONS = dict(adapter=True, adapter_dim=8, encoder_prompt=True, encoder_prompt_length=4,
               encoder_prompt_projection=True, encoder_prompt_dim=16,
               decoder_prompt=True, decoder_prompt_length=3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _linear(dst, node):
    with torch.no_grad():
        dst.weight.copy_(_t(node["kernel"]).t())
        dst.bias.copy_(_t(node["bias"]))


@pytest.fixture(scope="module")
def pair():
    """The tiny pair with every option on (prompts both sides, the encoder's
    projected, adapters)."""
    return make_pair(seed=0, **OPTIONS)


def test_adapter_math():
    x = np.random.default_rng(0).normal(size=(2, 5, 16)).astype(np.float32)
    jmod = JaxAdapter(embed_dim=16, down_size=4)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tmod = TorchAdapter(16, 4)
    _linear(tmod.down_proj, params["down_proj"])
    _linear(tmod.up_proj, params["up_proj"])
    with torch.no_grad():
        got = tmod(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmod.apply({"params": params}, x)),
                               atol=1e-5)


@pytest.mark.parametrize("projection", [False, True])
def test_prompt_encoder_matches_jax(projection):
    kw = dict(projection=projection, proj_dim=16 if projection else 0)
    jmod = JaxPrompt(length=7, embed_dim=32, num_layers=3, num_heads=4, **kw)
    params = jax.device_get(jmod.init({"params": jax.random.PRNGKey(1)}, deterministic=True)
                            ["params"])
    tmod = TorchPrompt(7, 32, 3, 4, projection, kw["proj_dim"]).eval()
    with torch.no_grad():
        tmod.embedding.weight.copy_(_t(params["embedding"]["embedding"]))
        if projection:
            _linear(tmod.trans[0], params["trans_0"])
            _linear(tmod.trans[2], params["trans_2"])
        got = tmod()
    want = np.asarray(jmod.apply({"params": params}, deterministic=True))
    assert tuple(got.shape) == want.shape == (3, 2, 4, 7, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)


def _mha_pair(d=16, h=4, seed=0, x=None, **call):
    jmod = JaxMHA(d, h, scale_factor=2.0, scale_heads=True)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(seed), x, **call)["params"])
    params = jax.tree_util.tree_map(
        lambda a: a + np.random.default_rng(seed).normal(0, 0.05, a.shape).astype(np.float32),
        params)
    tmod = TorchMHA(d, h, 2.0, True).eval()
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(getattr(tmod, name), params[name])
    with torch.no_grad():
        tmod.c_attn.copy_(_t(params["c_attn"]))
    return jmod, params, tmod


@pytest.mark.parametrize("case", ["prefix", "prefix_causal_masked", "prefix_grad",
                                  "grouped_cross", "bias_4d", "grouped_bias_4d"])
def test_attention_paths_match_jax(case):
    rng = np.random.default_rng(1)
    b, l, d, h, p = 2, 6, 16, 4, 3
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    jcall, tcall = {}, {}
    if case.startswith("prefix"):
        bias = rng.normal(size=(h, l, l)).astype(np.float32)
        pkv = rng.normal(size=(2, h, p, d // h)).astype(np.float32)
        jcall = dict(bias=bias, prompt_kv=pkv)
        if case == "prefix_causal_masked":
            mask = np.zeros((b, l), bool)
            mask[1, -2:] = True
            jcall.update(causal=True, key_padding_mask=mask)
    else:
        g = 3 if case.startswith("grouped") else 1
        bk, lk = b, 5
        x = rng.normal(size=(bk * g, l, d)).astype(np.float32)
        key = rng.normal(size=(bk, lk, d)).astype(np.float32)
        bias = rng.normal(size=(h, l, lk) if case == "grouped_cross" else
                          (bk * g, h, l, lk)).astype(np.float32)
        mask = rng.random(size=(bk, lk)) < 0.3
        jcall = dict(key=key, bias=bias, key_padding_mask=mask)
    jmod, params, tmod = _mha_pair(x=x, **{k: v for k, v in jcall.items()
                                           if k in ("key", "bias") and case != "prefix_grad"
                                           or k == "key"})
    want = jmod.apply({"params": params}, x, **jcall)
    tcall = {k: _t(v) for k, v in jcall.items() if k != "causal"}
    tcall["causal"] = jcall.get("causal", False)
    if case == "prefix_grad":
        # the prompts' gradient comes through dk/dv of the prefix rows
        tcall["prompt_kv"].requires_grad_(True)
        got = tmod(_t(x), **tcall)
        got.square().sum().backward()
        jgrad = jax.grad(lambda pk: jnp.sum(jnp.square(jmod.apply(
            {"params": params}, x, bias=bias, prompt_kv=pk))))(jnp.asarray(pkv))
        np.testing.assert_allclose(tcall["prompt_kv"].grad.numpy(), np.asarray(jgrad),
                                   atol=TOL, rtol=TOL)
    else:
        with torch.no_grad():
            got = tmod(_t(x), **tcall)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def _jax_aux(jmodel, params, batch, tokens, lengths):
    _, extra = jmodel.apply(
        {"params": params}, aux_grid_ids=jnp.asarray(batch["aux_grid_ids"]),
        aux_src_tokens=jnp.asarray(batch["src_tokens"]),
        bos_tokens=jnp.asarray(batch["bos_tokens"]), class_tokens=jnp.asarray(tokens),
        class_lengths=jnp.asarray(lengths), deterministic=True)
    return extra["aux_output"]


def test_imfree_loss_and_gradients_match_jax_grad(pair):
    jmodel, params, tmodel = pair
    tokens, lengths = class_table(NUM_SEG)
    batch = train_batch(seed=3)
    target = batch["aux_target"]

    def jloss(p):
        return j_imfree(_jax_aux(jmodel, p, batch, tokens, lengths), jnp.asarray(target),
                        NUM_SEG, (HW, HW), 0.0)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jax.tree_util.tree_map(jnp.asarray, params))
    want = state_dict_from_jax(jax.device_get(jgrads))
    for p in tmodel.parameters():
        p.requires_grad_(True)
    t = lambda k: _t(batch[k]).long()
    _, extra = tmodel(aux_grid_ids=t("aux_grid_ids"), aux_src_tokens=t("src_tokens"),
                      bos_tokens=t("bos_tokens"), class_tokens=_t(tokens).long(),
                      class_lengths=_t(lengths).long())
    loss = t_imfree(extra["aux_output"], _t(target).long(), NUM_SEG, (HW, HW), 0.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    for name, p in tmodel.named_parameters():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(got - ref)
        assert err <= TOL * np.linalg.norm(ref) + 1e-7, f"{name}: {err} vs {np.linalg.norm(ref)}"
    for name in ("encoder.encoder_prompt_encoder.trans.2.weight",
                 "decoder.decoder_prompt_encoder.embedding.weight",
                 "encoder.layers.1.adapter.down_proj.weight", "decoder.layers.0.adapter.up_proj.bias"):
        assert np.linalg.norm(want[name].numpy()) > 0 and tmodel.get_parameter(name).grad is not None
    for p in tmodel.parameters():
        p.requires_grad_(False)
        p.grad = None


@pytest.mark.parametrize("flags", [{}, {"bitfit": True}, {"encoder_prompt": True},
                                   {"decoder_prompt": True, "adapter": True}, {"adapter": True}],
                         ids=["default", "bitfit", "prompt", "prompt_adapter", "adapter"])
def test_freeze_mask_matches_jax_leaf_by_leaf(pair, flags):
    """The JAX rules on the JAX tree, the port's on its names, for each
    config's flags (the rules read only the flags and the names)."""
    _, params, tmodel = pair
    off = dict(adapter=False, encoder_prompt=False, decoder_prompt=False, bitfit=False)
    jcfg = jax_model_config("segofa_tiny", **{**TINY, **off, **flags})
    tcfg = torch_model_config("segofa_tiny", **{**TINY, **off, **flags})
    jmask = j_freeze_mask(params, jcfg)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    tmask = toptim.freeze_mask(tmodel, tcfg)
    paths = toptim.jax_paths(tmodel)
    ours = {paths[n][0] for n in tmask} - {"decoder/embed_image_positions/embedding"}
    # the JAX tree's other leaves are the frozen BNs' four arrays, buffers here
    assert ours <= set(flat) and all("bn" in k.split("/")[-2] for k in set(flat) - ours)
    for name, trainable in tmask.items():
        if name != "decoder.embed_image_positions.weight":
            assert trainable == flat[paths[name][0]], (name, paths[name][0])
    assert any(tmask.values()) and not all(tmask.values())


def test_prefix_tuning_trains_only_the_prompt_encoders():
    """At OFA-Base's width and 100 prefix rows a side (no projection), the
    prompt encoders are 2 · 100 · 6 · 2 · 768 = 1,843,200 parameters (counted
    on the config's shapes: no model is built)."""
    cfg = torch_model_config("segofa_base", encoder_prompt=True, decoder_prompt=True)
    side = cfg.encoder_prompt_length * cfg.encoder_layers * 2 * cfg.encoder_embed_dim
    assert 2 * side == 1_843_200
    tmodel = make_pair.__globals__["TorchSegOFA"](torch_model_config(
        "segofa_tiny", **{**TINY, "encoder_prompt": True, "decoder_prompt": True}))
    mask = toptim.freeze_mask(tmodel, tmodel.cfg)
    trained = {n for n, t in mask.items() if t}
    assert trained == {"encoder.encoder_prompt_encoder.embedding.weight",
                       "decoder.decoder_prompt_encoder.embedding.weight"}
    assert sum(tmodel.get_parameter(n).numel() for n in trained) == 2 * 100 * 2 * 2 * 32


def test_served_path_ignores_prefixes_as_jax_does(pair):
    jmodel, params, tmodel = pair
    src, img, bos = serving_inputs(seed=4)
    want = np.asarray(JaxSegServer(jmodel, params, src_len=10)(
        jnp.asarray(src), jnp.asarray(img), jnp.asarray(bos)))
    got = TorchSegServer(tmodel, src_len=10, device="cpu")(_t(src), _t(img), _t(bos))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the same weights without the prompt encoders answer the same
    bare = dict(OPTIONS, encoder_prompt=False, decoder_prompt=False)
    plain = make_pair.__globals__["TorchSegOFA"](torch_model_config("segofa_tiny", **TINY, **bare))
    plain.load_state_dict({k: v for k, v in tmodel.state_dict().items()
                           if "prompt_encoder" not in k}, strict=True)
    again = TorchSegServer(plain.eval(), src_len=10, device="cpu")(_t(src), _t(img), _t(bos))
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    # while the in-graph forward applies them
    with torch.no_grad():
        logits, _ = tmodel(src_tokens=_t(src).long(), patch_images=_t(img),
                           bos_tokens=_t(bos).long())
    assert np.abs(logits.numpy() - got.numpy()).max() > 1e-3


def test_decode_ar_with_prompts_and_adapters_matches_jax(pair):
    """``decode_ar`` applies the decoder prefixes (and the adapters) as the
    JAX one does, over the image-free encoder output with its prefixes."""
    jmodel, params, tmodel = pair
    src, _, _ = serving_inputs(5)
    grid = np.random.default_rng(5).integers(0, NUM_SEG, size=(2, HW * HW)).astype(np.int32)
    tokens, lengths = class_table(NUM_SEG)
    jenc = jmodel.apply({"params": params}, method=lambda m, *a: m.encoder.encode_artificial(*a),
                        *(jnp.asarray(x) for x in (src, grid, tokens, lengths)))
    prev = np.random.default_rng(6).integers(0, NUM_SEG, size=(2, 6)).astype(np.int32)
    prev[:, 0] = 0
    want = jmodel.apply({"params": params}, jnp.asarray(prev), jenc,
                        method=lambda m, t, e: m.decoder.decode_ar(t, e))
    with torch.no_grad():
        tenc = tmodel.encoder.encode_artificial(*(_t(x).long() for x in (src, grid, tokens,
                                                                            lengths)))
        got = tmodel.decoder.decode_ar(_t(prev).long(), tenc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_reference_checkpoint_with_prompt_and_adapter_keys(pair, tmp_path):
    _, _, tmodel = pair
    path = tmp_path / "tuned.pt"
    torch.save({"model": tmodel.state_dict()}, path)
    loaded = load_model(str(path), tmodel.cfg)
    for name in ("encoder.encoder_prompt_encoder.trans.0.weight",
                 "decoder.decoder_prompt_encoder.embedding.weight",
                 "decoder.layers.1.adapter.up_proj.weight"):
        np.testing.assert_array_equal(loaded.get_parameter(name).detach().numpy(),
                                      tmodel.get_parameter(name).detach().numpy())
    bare = torch_model_config("segofa_tiny", **TINY)
    with pytest.raises(ValueError, match="prompt-encoder or adapter"):
        load_model(str(path), bare)
