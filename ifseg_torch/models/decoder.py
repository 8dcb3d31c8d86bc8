"""SegOFA surrogate decoder: one non-autoregressive parallel pass.

Mirrors models/segofa/decoder_module.py (``extract_features_scriptable_
surrogate``) as the JAX package's ``Decoder`` computes it: decoder input = [BOS
embedding ‖ encoder image rows], causal self-attention unless
``full_context_alignment``, cross-attention to the whole encoder sequence
with a q·kᵀ cross position bias, and the seg head as an fp32 product with
``seg_embed_tokens``.  Output position i predicts grid cell i.

``decode_served`` runs over biases precomputed once per checkpoint
(``precompute_biases``); ``forward`` builds them in the graph, so the position
parameters get their gradients through the attention kernels' dbias: the
self-bias pack (layers, H, L, L) in compute dtype, and one cross bias shared
by all layers, which therefore receives one dbias from each of them.

``decode_ar`` is the autoregressive path (decoder_module.py:680-862): the
full causal recompute over the tokens generated so far, with text positions
(``embed_positions``, ``pos_ln``) and the per-layer token relative bias; the
KV-cached step is ``models/ar_cache.py``.  The decoder also holds the
reference's ``embed_image_positions`` and ``image_rel_pos_table_list``, which
no path reads, so a full state dict loads strictly.

With ``decoder_prompt`` (prefix tuning) ``decoder_prompt_encoder`` makes the
per-layer key/value prefixes once a forward, prepended in self-attention by
``forward`` and ``decode_ar`` (the causal offset keeps the whole prefix
visible); ``decode_served`` applies none, as the JAX package's
``decode_served`` calls its layers without them
(``ifseg_tpu/models/decoder.py:464-467``; ROADMAP.md C.4).
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ifseg_torch.config import ModelConfig
from ifseg_torch.ops.flash_attention import row_padded
from ifseg_torch.ops.resize import bilinear_dyn_tensor, resize_bilinear
from .ar_cache import check_ar_length
from .attention import Dropout, Linear, prefixed_pack
from .encoder import LayerDrop, _ids, compute_dtype, stack_tables
from .layers import DecoderLayer, LayerNorm, PromptEncoder, run_layer
from .position import (
    gather_grid_bias_all_layers,
    gather_rel_bias_all_layers,
    image_num_rel_dis,
    interp_seg_bias_with_bos,
    interp_seg_bias_with_bos_mats,
    make_image_bucket_position,
    make_token_bucket_position,
)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, embed_tokens: nn.Embedding):
        super().__init__()
        self.cfg = cfg
        d = cfg.decoder_embed_dim
        heads = cfg.decoder_attention_heads
        nl = cfg.decoder_layers
        sb = cfg.seg_bucket_size
        self.embed_tokens = embed_tokens  # shared with the encoder
        self.seg_embed_tokens = nn.Embedding(cfg.num_seg_tokens, d)
        self.seg_projection = (
            None if cfg.tie_seg_projection else nn.Embedding(cfg.num_seg_tokens, d)
        )
        self.layernorm_embedding = LayerNorm(d) if cfg.layernorm_embedding else None
        self.embed_positions = nn.Embedding(cfg.max_target_positions + 2, d)
        self.embed_image_positions = nn.Embedding(cfg.image_bucket_size**2 + 1, d)
        self.embed_seg_positions = nn.Embedding(sb**2 + 1, d)
        self.pos_ln = LayerNorm(d)
        self.seg_pos_ln = LayerNorm(d)
        self.self_pos_q_linear = Linear(d, d)
        self.self_pos_k_linear = Linear(d, d)
        self.cross_pos_q_linear = Linear(d, d)
        self.cross_pos_k_linear = Linear(d, d)
        self.token_rel_pos_table_list = nn.ModuleList(
            nn.Embedding(2 * cfg.token_bucket_size - 1, heads) for _ in range(nl)
        )
        self.image_rel_pos_table_list = nn.ModuleList(
            nn.Embedding(image_num_rel_dis(cfg.image_bucket_size), heads)
            for _ in range(nl)
        )
        self.seg_rel_pos_table_list = nn.ModuleList(
            nn.Embedding((2 * sb - 1) * (2 * sb - 1) + 3, heads) for _ in range(nl)
        )
        self.layers = nn.ModuleList(
            DecoderLayer(
                d, cfg.decoder_ffn_embed_dim, heads,
                attn_scale_factor=cfg.attn_scale_factor, scale_attn=cfg.scale_attn,
                scale_fc=cfg.scale_fc, scale_heads=cfg.scale_heads,
                scale_resids=cfg.scale_resids, activation_fn=cfg.activation_fn,
                use_adapter=cfg.adapter, adapter_dim=cfg.adapter_dim,
                dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
                activation_dropout=cfg.activation_dropout, drop_path_rate=float(rate),
                use_flash=cfg.use_flash_attention,
            )
            for rate in np.linspace(0, cfg.decoder_drop_path_rate, nl)
        )
        self.layer_norm = LayerNorm(d)
        self.dropout_layer = Dropout(cfg.dropout)
        self.layerdrop = LayerDrop(cfg.decoder_layerdrop)
        self.decoder_prompt_encoder = PromptEncoder(
            cfg.decoder_prompt_length, d, nl, heads, cfg.decoder_prompt_projection,
            cfg.decoder_prompt_dim) if cfg.decoder_prompt else None

    def prompt_kv_all(self) -> Optional[torch.Tensor]:
        """(layers, 2, H, P, dh) prefix key/values, or None without prefix
        tuning (decoder_module.py:501-510)."""
        if self.decoder_prompt_encoder is None or self.cfg.decoder_prompt_type != "prefix":
            return None
        return self.decoder_prompt_encoder()

    def _bias(self, q_pos, k_pos, q_linear, k_linear) -> torch.Tensor:
        cfg = self.cfg
        heads = cfg.decoder_attention_heads
        scaling = float(cfg.decoder_embed_dim / heads * cfg.attn_scale_factor) ** -0.5
        q = (q_linear(q_pos) * scaling).reshape(q_pos.shape[0], heads, -1)
        k = k_linear(k_pos).reshape(k_pos.shape[0], heads, -1)
        return torch.einsum("qhd,khd->hqk", q, k)

    def _seg_pos_embed(self, h: int, w: int, valid_mats=None) -> torch.Tensor:
        """(1 + h*w, D): the BOS slot, then the seg grid, interpolated from
        the seg-bucket grid when (h, w) differs (decoder_module.py:541-550);
        with ``valid_mats`` (ah, aw), by those dynamic-valid matrices."""
        sb = self.cfg.seg_bucket_size
        dev = self.embed_seg_positions.weight.device
        grid_ids = (np.arange(sb)[None, :] + np.arange(sb)[:, None] * sb + 1).reshape(-1)
        pe = self.embed_seg_positions(_ids(grid_ids, dev))
        if valid_mats is not None:
            ah, aw = valid_mats
            pe = torch.einsum("Hi,ijd->Hjd", ah, pe.reshape(sb, sb, -1).float())
            pe = torch.einsum("Wj,Hjd->HWd", aw, pe).reshape(h * w, -1)
        elif (h, w) != (sb, sb):
            pe = resize_bilinear(pe.reshape(sb, sb, -1), (h, w), h_axis=0, w_axis=1)
            pe = pe.reshape(h * w, -1)
        return torch.cat([self.embed_seg_positions.weight[:1], pe], dim=0)

    def _abs_biases(self, enc_pos_all: torch.Tensor, h: int, w: int, valid_mats=None):
        """fp32 absolute-position biases for an (h, w) target grid: self
        (H, 1+hw, 1+hw) and cross (H, 1+hw, L_enc) to the encoder's post-LN
        position embeddings ``enc_pos_all``."""
        tgt_pos_ln = self.seg_pos_ln(self._seg_pos_embed(h, w, valid_mats))
        self_bias0 = self._bias(
            tgt_pos_ln, tgt_pos_ln, self.self_pos_q_linear, self.self_pos_k_linear
        )
        cross_bias = self._bias(
            tgt_pos_ln, enc_pos_all, self.cross_pos_q_linear, self.cross_pos_k_linear
        )
        return self_bias0, cross_bias

    def precompute_biases(self, enc_pos_all: torch.Tensor, image_hw) -> Dict[str, torch.Tensor]:
        """Self biases (layers, H, 1+hw, 1+hw) — abs + per-layer seg rel — and
        the cross bias (H, 1+hw, L_enc) to a fixed encoder layout, in compute
        dtype."""
        cfg = self.cfg
        cd = compute_dtype(cfg)
        h, w = image_hw
        sb = cfg.seg_bucket_size
        self_bias0, cross_bias = self._abs_biases(enc_pos_all, h, w)
        seg_bucket = make_image_bucket_position(sb, (2 * sb - 1) * (2 * sb - 1) + 3)
        seg_all = gather_rel_bias_all_layers(stack_tables(self.seg_rel_pos_table_list), seg_bucket)
        self_biases = [
            (self_bias0 + interp_seg_bias_with_bos(seg_all[i], (sb, sb), (h, w))).to(cd)
            for i in range(len(self.layers))
        ]
        # rows a multiple of 16 bytes apart (1 + hw keys is odd): the attention
        # kernel then fetches the bias by TMA
        return {"self_biases": row_padded(torch.stack(self_biases)),
                "cross_bias": row_padded(cross_bias.to(cd))}

    def _embed(self, bos_tokens, encoder_out):
        """Decoder input (B, 1+hw, D): [BOS embedding ‖ image rows] + LN + dropout."""
        cfg = self.cfg
        cd = compute_dtype(cfg)
        h, w = encoder_out["image_embed_shape"]
        if cfg.decoder_input_type == "encoder_output":
            image_feats = encoder_out["encoder_out"][:, : h * w]
        elif cfg.decoder_input_type == "encoder_input":
            image_feats = encoder_out["image_embed_before_scale"]
        else:
            raise ValueError(cfg.decoder_input_type)
        x = torch.cat([self.embed_tokens(bos_tokens).to(cd), image_feats], dim=1)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x, cd)
        return self.dropout_layer(x)

    def forward(self, bos_tokens, encoder_out, full_context_alignment: bool = False):
        """Surrogate decode with the biases built in the graph -> (B, 1+hw,
        num_seg) fp32 logits.  ``encoder_out`` is what ``Encoder.encode`` /
        ``encode_artificial`` / ``encode_padded`` return.  After
        ``encode_padded`` (``valid_hw`` present) the grid (h, w) is a padded
        one: the seg positions and the seg relative bias are interpolated to
        the valid corner by dynamic-valid matrices, and the padded cells are
        masked as self-attention keys (the BOS slot stays valid, so no row
        is fully masked)."""
        cfg = self.cfg
        cd = compute_dtype(cfg)
        h, w = encoder_out["image_embed_shape"]
        sb = cfg.seg_bucket_size
        x = self._embed(bos_tokens, encoder_out)

        valid_mats = self_padding_mask = None
        if "valid_hw" in encoder_out:
            hp, wp = encoder_out["valid_hw"]
            valid_mats = (bilinear_dyn_tensor(sb, h, hp, device=x.device),
                          bilinear_dyn_tensor(sb, w, wp, device=x.device))
            grid_pad = ~encoder_out["grid_valid"]
            self_padding_mask = torch.cat([grid_pad.new_zeros(1), grid_pad])[None, :].expand(
                x.shape[0], 1 + h * w).contiguous()

        self_bias0, cross_bias = self._abs_biases(
            encoder_out["position_embeddings"], h, w, valid_mats)
        cross_bias = row_padded(cross_bias.to(cd))
        seg_bucket = make_image_bucket_position(sb, (2 * sb - 1) * (2 * sb - 1) + 3)
        ident_interp = valid_mats is None and (sb, sb) == (h, w)
        seg_all = gather_grid_bias_all_layers(
            stack_tables(self.seg_rel_pos_table_list), seg_bucket, (sb, sb), bos=True,
            dtype=cd if ident_interp else torch.float32,
        )
        if valid_mats is not None:
            seg_all = torch.stack(
                [interp_seg_bias_with_bos_mats(b, *valid_mats, (sb, sb)) for b in seg_all]
            )
        elif not ident_interp:
            seg_all = torch.stack(
                [interp_seg_bias_with_bos(b, (sb, sb), (h, w)) for b in seg_all]
            )
        # summed in row-padded storage (1 + hw keys is odd; rows a multiple of
        # 16 bytes apart), in the graph: the kernels fetch the bias by TMA in
        # both passes, and the cast of seg_all is the copy into that storage;
        # under prefix tuning P zero columns go in front
        prompts = self.prompt_kv_all()
        p = 0 if prompts is None else prompts.shape[3]
        pack, body = prefixed_pack(seg_all.shape, p, cd, seg_all.device)
        body.copy_(seg_all).add_(self_bias0.to(cd))

        enc = encoder_out["encoder_out"]
        enc_pad = encoder_out["encoder_padding_mask"]
        for i, (layer, self_bias) in enumerate(zip(self.layers, pack.unbind(0))):
            args = (x, enc, enc_pad, self_bias, cross_bias, self_padding_mask,
                    not full_context_alignment) + (() if prompts is None else (prompts[i],))
            x = self.layerdrop(run_layer(layer, cfg, *args), x)
        x = self.layer_norm(x, cd)
        return self.output_layer(x)

    def decode_served(self, bos_tokens, encoder_out, pre, full_context_alignment: bool = False):
        """Surrogate decode with precomputed biases -> (B, 1+hw, num_seg) fp32."""
        cd = compute_dtype(self.cfg)
        enc = encoder_out["encoder_out"]
        x = self._embed(bos_tokens, encoder_out)
        enc_pad = encoder_out["encoder_padding_mask"]
        # no prefix here, as in the JAX package's decode_served (see the
        # module docstring): ifseg_tpu/models/decoder.py:464-467
        for i, layer in enumerate(self.layers):
            x = layer(x, enc, enc_pad, pre["self_biases"][i], pre["cross_bias"],
                      None, not full_context_alignment)
        x = self.layer_norm(x, cd)
        return self.output_layer(x)

    def decode_ar(self, prev_tokens, encoder_out, embed_mode: str = "seg"):
        """Autoregressive decode, the full causal recompute
        (decoder_module.py:680-862; the JAX package's ``decode_ar``):
        prev_tokens (B, t) generated ids -> (B, t, num_seg) fp32 logits.
        ``embed_mode="seg"`` embeds position 0 (BOS) by the token embedding
        and later class ids by ``seg_embed_tokens`` rows (ids clipped to
        [0, num_seg)); ``"vocab"`` embeds every id by the token embedding.
        Text positions give the self bias (abs q·k plus each layer's token
        relative bias) and the cross bias to the encoder's positions;
        causal self-attention over the t tokens (and the decoder prefixes
        under prefix tuning), cross-attention to ``encoder_out``.  The biases
        are built row-padded in compute dtype, so on the card, under
        ``no_grad`` and with ``encoder_out`` of B rows (``build_generator``
        tiles it over the beam), every attention is K1 (Lq = Lk = t causal,
        and t over the encoder's keys) and every LayerNorm K4; an
        ``encoder_out`` of a divisor of B rows takes grouped cross-attention,
        plain as in the JAX package."""
        cfg = self.cfg
        cd = compute_dtype(cfg)
        t = prev_tokens.shape[1]
        check_ar_length(t)
        if embed_mode == "seg":
            bos = self.embed_tokens(prev_tokens[:, :1])
            rest = self.seg_embed_tokens(prev_tokens[:, 1:].clamp(0, cfg.num_seg_tokens - 1))
            x = torch.cat([bos, rest], dim=1).to(cd)
        elif embed_mode == "vocab":
            x = self.embed_tokens(prev_tokens).to(cd)
        else:
            raise ValueError(f"embed_mode {embed_mode!r}: take seg or vocab")
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x, cd)
        x = self.dropout_layer(x)

        tgt_pos = self.pos_ln(self.embed_positions(torch.arange(t, device=x.device)))
        self_bias0 = self._bias(tgt_pos, tgt_pos, self.self_pos_q_linear, self.self_pos_k_linear)
        cross_bias = row_padded(self._bias(
            tgt_pos, encoder_out["position_embeddings"], self.cross_pos_q_linear,
            self.cross_pos_k_linear).to(cd))
        token_bucket = make_token_bucket_position(cfg.token_bucket_size)[:t, :t]
        tok_all = gather_rel_bias_all_layers(stack_tables(self.token_rel_pos_table_list),
                                             token_bucket)
        prompts = self.prompt_kv_all()
        p = 0 if prompts is None else prompts.shape[3]
        pack, body = prefixed_pack(tok_all.shape, p, cd, x.device)
        body.copy_(self_bias0[None] + tok_all)

        enc = encoder_out["encoder_out"]
        enc_pad = encoder_out["encoder_padding_mask"]
        for i, layer in enumerate(self.layers):
            x = layer(x, enc, enc_pad, pack[i], cross_bias, None, True,
                      None if prompts is None else prompts[i])
        return self.output_layer(self.layer_norm(x, cd))

    def output_layer(self, features):
        """seg head: (B, L, D) -> (B, L, num_seg), fp32 (decoder_module.py:290-294)."""
        w = (self.seg_embed_tokens if self.seg_projection is None else self.seg_projection).weight
        return torch.matmul(features.float(), w.float().t())
