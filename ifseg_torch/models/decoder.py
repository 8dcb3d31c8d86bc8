"""SegOFA surrogate decoder for the served forward: one non-autoregressive
parallel pass.

Mirrors models/segofa/decoder_module.py (``extract_features_scriptable_
surrogate``) as the JAX package's ``Decoder.precompute_biases`` /
``decode_served`` / ``output_layer`` compute it: decoder input = [BOS
embedding ‖ encoder image rows], causal self-attention unless
``full_context_alignment``, cross-attention to the whole encoder sequence
with a q·kᵀ cross position bias, and the seg head as an fp32 product with
``seg_embed_tokens``.  Output position i predicts grid cell i.

The decoder also holds the parameters of the autoregressive path
(``embed_positions``, ``embed_image_positions``, ``pos_ln``,
``token_rel_pos_table_list``, ``image_rel_pos_table_list``), which the
served forward does not read, so a full state dict loads strictly.
"""

from typing import Dict

import numpy as np
import torch
from torch import nn

from ifseg_torch.config import ModelConfig
from ifseg_torch.ops.resize import resize_bilinear
from .attention import Linear
from .encoder import _ids, compute_dtype, stack_tables
from .layers import DecoderLayer, LayerNorm
from .position import (
    gather_rel_bias_all_layers,
    image_num_rel_dis,
    interp_seg_bias_with_bos,
    make_image_bucket_position,
)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, embed_tokens: nn.Embedding):
        super().__init__()
        if cfg.adapter:
            raise NotImplementedError("adapters are not ported")
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
            )
            for _ in range(nl)
        )
        self.layer_norm = LayerNorm(d)

    def _bias(self, q_pos, k_pos, q_linear, k_linear) -> torch.Tensor:
        cfg = self.cfg
        heads = cfg.decoder_attention_heads
        scaling = float(cfg.decoder_embed_dim / heads * cfg.attn_scale_factor) ** -0.5
        q = (q_linear(q_pos) * scaling).reshape(q_pos.shape[0], heads, -1)
        k = k_linear(k_pos).reshape(k_pos.shape[0], heads, -1)
        return torch.einsum("qhd,khd->hqk", q, k)

    def _seg_pos_embed(self, h: int, w: int) -> torch.Tensor:
        """(1 + h*w, D): the BOS slot, then the seg grid, interpolated from
        the seg-bucket grid when (h, w) differs (decoder_module.py:541-550)."""
        sb = self.cfg.seg_bucket_size
        dev = self.embed_seg_positions.weight.device
        grid_ids = (np.arange(sb)[None, :] + np.arange(sb)[:, None] * sb + 1).reshape(-1)
        pe = self.embed_seg_positions(_ids(grid_ids, dev))
        if (h, w) != (sb, sb):
            pe = resize_bilinear(pe.reshape(sb, sb, -1), (h, w), h_axis=0, w_axis=1)
            pe = pe.reshape(h * w, -1)
        return torch.cat([self.embed_seg_positions.weight[:1], pe], dim=0)

    def precompute_biases(self, enc_pos_all: torch.Tensor, image_hw) -> Dict[str, torch.Tensor]:
        """Self biases (layers, H, 1+hw, 1+hw) — abs + per-layer seg rel — and
        the cross bias (H, 1+hw, L_enc) to a fixed encoder layout, in compute
        dtype."""
        cfg = self.cfg
        cd = compute_dtype(cfg)
        h, w = image_hw
        sb = cfg.seg_bucket_size
        tgt_pos_ln = self.seg_pos_ln(self._seg_pos_embed(h, w))
        self_bias0 = self._bias(
            tgt_pos_ln, tgt_pos_ln, self.self_pos_q_linear, self.self_pos_k_linear
        )
        cross_bias = self._bias(
            tgt_pos_ln, enc_pos_all, self.cross_pos_q_linear, self.cross_pos_k_linear
        )
        seg_bucket = make_image_bucket_position(sb, (2 * sb - 1) * (2 * sb - 1) + 3)
        seg_all = gather_rel_bias_all_layers(stack_tables(self.seg_rel_pos_table_list), seg_bucket)
        self_biases = [
            (self_bias0 + interp_seg_bias_with_bos(seg_all[i], (sb, sb), (h, w))).to(cd)
            for i in range(len(self.layers))
        ]
        return {"self_biases": torch.stack(self_biases), "cross_bias": cross_bias.to(cd)}

    def decode_served(self, bos_tokens, encoder_out, pre, full_context_alignment: bool = False):
        """Surrogate decode with precomputed biases -> (B, 1+hw, num_seg) fp32."""
        cfg = self.cfg
        cd = compute_dtype(cfg)
        h, w = encoder_out["image_embed_shape"]
        enc = encoder_out["encoder_out"]
        if cfg.decoder_input_type == "encoder_output":
            image_feats = enc[:, : h * w]
        elif cfg.decoder_input_type == "encoder_input":
            image_feats = encoder_out["image_embed_before_scale"]
        else:
            raise ValueError(cfg.decoder_input_type)
        x = torch.cat([self.embed_tokens(bos_tokens).to(cd), image_feats], dim=1)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x).to(cd)
        enc_pad = encoder_out["encoder_padding_mask"]
        for i, layer in enumerate(self.layers):
            x = layer(x, enc, enc_pad, pre["self_biases"][i], pre["cross_bias"],
                      None, not full_context_alignment)
        x = self.layer_norm(x).to(cd)
        return self.output_layer(x)

    def output_layer(self, features):
        """seg head: (B, L, D) -> (B, L, num_seg), fp32 (decoder_module.py:290-294)."""
        w = (self.seg_embed_tokens if self.seg_projection is None else self.seg_projection).weight
        return torch.matmul(features.float(), w.float().t())
