"""KV-cached incremental autoregressive decoding (the JAX package's
``models/ar_cache.py``; the reference caches per-layer K/V in
``incremental_state``, decoder_module.py:680-862).

    cache = init_ar_cache(model, encoder_out, bsz * beam, max_len)
    logits, cache = ar_step(model, cache, tokens, step)

Each step embeds the token at ``step``, attends over the cached keys and
values (positions after ``step`` masked) and writes its own into the cache:
O(L) a step against ``Decoder.decode_ar``'s O(L²) recompute.  The biases
that do not depend on the batch (the abs position q·k, each layer's token
relative bias, the cross bias to the encoder) are made once, at init.

All of it in fp32 with its own two-pass LayerNorm, as the JAX package
computes it outside any Pallas kernel: plain ``torch`` products are its port,
on the device of the model.  The step mirrors the default decoder layer:
configs that add to the layer body (decoder prompts, adapters, scale_resids)
are refused, as there, and generate through ``decode_ar``.
"""

from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .encoder import stack_tables
from .layers import ACTIVATIONS
from .position import gather_rel_bias_all_layers, make_token_bucket_position

NEG_INF = -1e9
# the token relative bias covers this many positions (the reference's and
# the JAX package's make_token_bucket_position default): a cache of more, or a
# generation of more than AR_MAX_POSITIONS - 2 tokens, has no bias for the rest
AR_MAX_POSITIONS = 1024


def check_ar_length(length: int) -> None:
    """Raise where ``length`` decoder positions exceed the token relative
    bias's table.  The JAX package fails there too, on a shape mismatch, so
    its seg pin of max_len = min_len = 1,024 (1,026 positions with BOS and
    EOS) does not run in either package: 1,022 is the longest generation."""
    if length > AR_MAX_POSITIONS:
        raise ValueError(
            f"{length} decoder positions: the token relative bias covers {AR_MAX_POSITIONS} "
            f"(generate at most max_len = {AR_MAX_POSITIONS - 2} tokens)")


class ARCache(NamedTuple):
    self_k: List[torch.Tensor]  # per layer (B, Lmax, H, dh), written step by step
    self_v: List[torch.Tensor]
    cross_k: List[torch.Tensor]  # per layer (B, L_enc, H, dh), made once
    cross_v: List[torch.Tensor]
    self_bias: torch.Tensor  # (layers, H, Lmax, Lmax)
    cross_bias: torch.Tensor  # (H, Lmax, L_enc)
    enc_out: torch.Tensor  # (B, L_enc, D)
    enc_pad: torch.Tensor  # (B, L_enc)


def _ln(x, mod):
    """LayerNorm in fp32, two-pass variance, eps 1e-5 (the JAX ``_ln``)."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * mod.weight.float() + mod.bias.float()


def _dense(x, lin):
    return F.linear(x, lin.weight.float(), None if lin.bias is None else lin.bias.float())


def init_ar_cache(model, encoder_out: Dict[str, Any], bsz: int, max_len: int) -> ARCache:
    """An empty cache for ``bsz`` rows of up to ``max_len`` tokens over
    ``encoder_out`` (whose rows are the ``bsz`` rows, tiled over the beam)."""
    cfg = model.cfg
    unsupported = [flag for flag in ("decoder_prompt", "adapter", "scale_resids")
                   if getattr(cfg, flag, False)]
    if unsupported:
        raise NotImplementedError(
            f"KV-cached generation does not support {unsupported}; "
            "use use_kv_cache=False (decode_ar)")
    check_ar_length(max_len)
    dec = model.decoder
    heads = cfg.decoder_attention_heads
    hd = cfg.decoder_embed_dim // heads
    enc = encoder_out["encoder_out"].float()
    dev = enc.device
    with torch.no_grad():
        pos = _ln(dec.embed_positions.weight[:max_len].float(), dec.pos_ln)
        scaling = float(hd * cfg.attn_scale_factor) ** -0.5
        q = (_dense(pos, dec.self_pos_q_linear) * scaling).reshape(max_len, heads, hd)
        k = _dense(pos, dec.self_pos_k_linear).reshape(max_len, heads, hd)
        token_bucket = make_token_bucket_position(cfg.token_bucket_size)[:max_len, :max_len]
        tok_all = gather_rel_bias_all_layers(
            stack_tables(dec.token_rel_pos_table_list).float(), token_bucket)
        self_bias = torch.einsum("qhd,khd->hqk", q, k)[None] + tok_all
        src_pos = encoder_out["position_embeddings"].float()
        cq = (_dense(pos, dec.cross_pos_q_linear) * scaling).reshape(max_len, heads, hd)
        ck = _dense(src_pos, dec.cross_pos_k_linear).reshape(-1, heads, hd)
        cross_bias = torch.einsum("qhd,khd->hqk", cq, ck)
        l_enc = enc.shape[1]
        cross_k = [_dense(enc, lay.encoder_attn.k_proj).reshape(bsz, l_enc, heads, hd)
                   for lay in dec.layers]
        cross_v = [_dense(enc, lay.encoder_attn.v_proj).reshape(bsz, l_enc, heads, hd)
                   for lay in dec.layers]
    zeros = lambda: torch.zeros(bsz, max_len, heads, hd, device=dev)
    return ARCache(self_k=[zeros() for _ in dec.layers], self_v=[zeros() for _ in dec.layers],
                   cross_k=cross_k, cross_v=cross_v, self_bias=self_bias, cross_bias=cross_bias,
                   enc_out=enc, enc_pad=encoder_out["encoder_padding_mask"])


def _attend(q, k, v, bias, key_mask, attn):
    """q (B, H, dh); k/v (B, L, H, dh); bias (H, L); key_mask (B or 1, L)
    True = masked; then the head gain and ``attn``'s output projection."""
    logits = torch.einsum("bhd,blhd->bhl", q, k) + bias[None]
    logits = logits.masked_fill(key_mask[:, None, :], NEG_INF)
    out = torch.einsum("bhl,blhd->bhd", torch.softmax(logits, dim=-1), v)
    if attn.c_attn is not None:
        out = out * attn.c_attn.float()[None, :, None]
    return _dense(out.reshape(out.shape[0], -1), attn.out_proj)


@torch.no_grad()
def ar_step(model, cache: ARCache, tokens: torch.Tensor, step: int, embed_mode: str = "seg"
            ) -> Tuple[torch.Tensor, ARCache]:
    """tokens (B, Lmax) generated so far -> ((B, num_seg) fp32 logits of
    the token after ``step``, the cache with this step's keys and values
    written into it, in place)."""
    cfg = model.cfg
    dec = model.decoder
    heads = cfg.decoder_attention_heads
    hd = cfg.decoder_embed_dim // heads
    bsz, lmax = tokens.shape
    tok = tokens[:, step]
    emb = dec.embed_tokens.weight
    if embed_mode == "seg":
        # position 0 holds BOS (a vocab token), later positions class ids
        x = (emb[tok.clamp(min=0)] if step == 0
             else dec.seg_embed_tokens.weight[tok.clamp(0, cfg.num_seg_tokens - 1)])
    else:
        x = emb[tok]
    x = x.float()
    if dec.layernorm_embedding is not None:
        x = _ln(x, dec.layernorm_embedding)

    scaling = float(hd * cfg.attn_scale_factor) ** -0.5
    pos_mask = (torch.arange(lmax, device=tokens.device) > step)[None, :]  # the future
    act = ACTIVATIONS[cfg.activation_fn]
    for i, lay in enumerate(dec.layers):
        res = x
        y = _ln(x, lay.self_attn_layer_norm)
        sa = lay.self_attn
        q = (_dense(y, sa.q_proj) * scaling).reshape(bsz, heads, hd)
        cache.self_k[i][:, step] = _dense(y, sa.k_proj).reshape(bsz, heads, hd)
        cache.self_v[i][:, step] = _dense(y, sa.v_proj).reshape(bsz, heads, hd)
        y = _attend(q, cache.self_k[i], cache.self_v[i], cache.self_bias[i, :, step], pos_mask, sa)
        if lay.self_attn_ln is not None:
            y = _ln(y, lay.self_attn_ln)
        x = res + y

        res = x
        y = _ln(x, lay.encoder_attn_layer_norm)
        ca = lay.encoder_attn
        q = (_dense(y, ca.q_proj) * scaling).reshape(bsz, heads, hd)
        y = _attend(q, cache.cross_k[i], cache.cross_v[i], cache.cross_bias[:, step],
                    cache.enc_pad, ca)
        if lay.cross_attn_ln is not None:
            y = _ln(y, lay.cross_attn_ln)
        x = res + y

        res = x
        y = act(_dense(_ln(x, lay.final_layer_norm), lay.fc1))
        if lay.ffn_layernorm is not None:
            y = _ln(y, lay.ffn_layernorm)
        x = res + _dense(y, lay.fc2)

    x = _ln(x, dec.layer_norm)
    head = dec.seg_embed_tokens if dec.seg_projection is None else dec.seg_projection
    return x @ head.weight.float().t(), cache
