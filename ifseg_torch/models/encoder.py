"""SegOFA encoder for the served forward: ResNet image stem + token path +
OFA transformer stack.

Mirrors models/segofa/encoder_module.py (real-image path) as the JAX
package's ``Encoder.precompute_biases`` / ``encode_served`` compute it.  The
sequence order is [image ‖ text].  Every attention bias and position
embedding depends only on the parameters and the input shape, so
``precompute_biases`` builds them once per checkpoint as one (layers, H, L,
L) pack in compute dtype, and ``encode_served`` runs the per-request part.
"""

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ifseg_torch.config import ModelConfig
from ifseg_torch.ops.resize import resize_bilinear
from .attention import Linear
from .layers import EncoderLayer, LayerNorm
from .position import (
    gather_rel_bias_all_layers,
    image_grid_position_ids,
    image_num_rel_dis,
    image_rp_bucket_for_grid,
    interp_grid_bias,
    make_token_bucket_position,
)
from .resnet import RESNET_LAYERS, ResNetStem

PAD = 1


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def stack_tables(tables: nn.ModuleList) -> torch.Tensor:
    """Per-layer ``Embedding`` tables -> (layers, num_rel, H)."""
    return torch.stack([t.weight for t in tables])


def _ids(ids: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(device)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, embed_tokens: nn.Embedding):
        super().__init__()
        if cfg.adapter:
            raise NotImplementedError("adapters are not ported")
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        heads = cfg.encoder_attention_heads
        nl = cfg.encoder_layers
        self.embed_tokens = embed_tokens  # shared with the decoder
        self.type_embedding = nn.Embedding(2, d) if cfg.add_type_embedding else None
        self.layernorm_embedding = LayerNorm(d) if cfg.layernorm_embedding else None
        self.patch_layernorm_embedding = (
            LayerNorm(d) if cfg.patch_layernorm_embedding else None
        )
        self.embed_images = ResNetStem(RESNET_LAYERS[cfg.resnet_type])
        self.image_proj = Linear(1024, d)
        self.embed_positions = nn.Embedding(cfg.max_source_positions + 2, d)
        self.embed_image_positions = nn.Embedding(cfg.image_bucket_size**2 + 1, d)
        self.pos_ln = LayerNorm(d)
        self.image_pos_ln = LayerNorm(d)
        self.pos_q_linear = Linear(d, d)
        self.pos_k_linear = Linear(d, d)
        self.token_rel_pos_table_list = nn.ModuleList(
            nn.Embedding(2 * cfg.token_bucket_size - 1, heads) for _ in range(nl)
        )
        self.image_rel_pos_table_list = nn.ModuleList(
            nn.Embedding(image_num_rel_dis(cfg.image_bucket_size), heads)
            for _ in range(nl)
        )
        self.layers = nn.ModuleList(
            EncoderLayer(
                d, cfg.encoder_ffn_embed_dim, heads,
                attn_scale_factor=cfg.attn_scale_factor, scale_attn=cfg.scale_attn,
                scale_fc=cfg.scale_fc, scale_heads=cfg.scale_heads,
                scale_resids=cfg.scale_resids, activation_fn=cfg.activation_fn,
            )
            for _ in range(nl)
        )
        self.layer_norm = LayerNorm(d)

    def _abs_bias(self, pos_embed: torch.Tensor) -> torch.Tensor:
        """(H, L, L) fp32 q·kᵀ bias from post-LN position embeddings
        (encoder_module.py:611-621)."""
        cfg = self.cfg
        heads = cfg.encoder_attention_heads
        scaling = float(cfg.encoder_embed_dim / heads * cfg.attn_scale_factor) ** -0.5
        l = pos_embed.shape[0]
        q = (self.pos_q_linear(pos_embed) * scaling).reshape(l, heads, -1)
        k = self.pos_k_linear(pos_embed).reshape(l, heads, -1)
        return torch.einsum("qhd,khd->hqk", q, k)

    def _image_pos_embed(self, h: int, w: int) -> torch.Tensor:
        """(h*w, D) image position embeddings, bilinearly interpolated from
        the orig grid when the runtime grid is larger (encoder_module.py:358-371)."""
        cfg = self.cfg
        dev = self.embed_image_positions.weight.device
        orig_hw = cfg.orig_patch_image_size // 16
        if h * w > orig_hw * orig_hw:
            ids = image_grid_position_ids(orig_hw, orig_hw, cfg.image_bucket_size)
            pe = self.embed_image_positions(_ids(ids, dev)).reshape(orig_hw, orig_hw, -1)
            pe = resize_bilinear(pe, (h, w), h_axis=0, w_axis=1)
            return pe.reshape(h * w, -1)
        ids = image_grid_position_ids(h, w, cfg.image_bucket_size)
        return self.embed_image_positions(_ids(ids, dev))

    def precompute_biases(self, src_len: int, image_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """Batch-independent bias pack for a fixed input shape:
        ``pos_all`` (L, D) fp32 and ``biases`` (layers, H, L, L) in compute
        dtype, L = h*w + src_len."""
        cfg = self.cfg
        dev = self.pos_ln.weight.device
        h, w = image_hw
        hw = h * w
        t = src_len
        pos_text = self.pos_ln(self.embed_positions(torch.arange(t, device=dev)))
        pos_img = self.image_pos_ln(self._image_pos_embed(h, w))
        pos_all = torch.cat([pos_img, pos_text], dim=0)

        bias0 = self._abs_bias(pos_all)
        token_bucket = make_token_bucket_position(cfg.token_bucket_size)[:t, :t]
        tok_all = gather_rel_bias_all_layers(
            stack_tables(self.token_rel_pos_table_list), token_bucket
        )
        orig_hw = cfg.orig_patch_image_size // 16
        image_bucket = image_rp_bucket_for_grid(orig_hw, orig_hw, cfg.image_bucket_size)
        img_all = gather_rel_bias_all_layers(
            stack_tables(self.image_rel_pos_table_list), image_bucket
        )
        biases = []
        for i in range(len(self.layers)):
            bias = bias0.clone()
            bias[:, hw:, hw:] += tok_all[i]
            bias[:, :hw, :hw] += interp_grid_bias(img_all[i], (orig_hw, orig_hw), image_hw)
            biases.append(bias.to(compute_dtype(cfg)))
        return {"pos_all": pos_all, "biases": torch.stack(biases)}

    def _text_embed(self, src_tokens):
        """Token path: embed + type(0) + LN (encoder_module.py:573-586)."""
        cd = compute_dtype(self.cfg)
        x = self.embed_tokens(src_tokens).to(cd)
        if self.type_embedding is not None:
            x = x + self.type_embedding.weight[0].to(cd)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x).to(cd)
        return x

    def _image_token_embed(self, image_embed):
        """Image path: + type(1) + patch LN (encoder_module.py:589-600)."""
        cd = compute_dtype(self.cfg)
        x = image_embed.to(cd)
        if self.type_embedding is not None:
            x = x + self.type_embedding.weight[1].to(cd)
        if self.patch_layernorm_embedding is not None:
            x = self.patch_layernorm_embedding(x).to(cd)
        return x

    def encode_served(self, src_tokens, patch_images, pre) -> Dict:
        """Forward with precomputed biases.  src_tokens (B, T) int,
        patch_images (B, H, W, 3) normalized."""
        cd = compute_dtype(self.cfg)
        feats = self.embed_images(patch_images.to(cd))
        b, h, w, _ = feats.shape
        hw = h * w
        image_embed_pre = self.image_proj(feats.reshape(b, hw, -1))
        image_pad = torch.zeros(b, hw, dtype=torch.bool, device=src_tokens.device)
        padding_mask = torch.cat([image_pad, src_tokens == PAD], dim=1)

        x = torch.cat(
            [self._image_token_embed(image_embed_pre), self._text_embed(src_tokens)], dim=1
        )
        x = x * (1.0 - padding_mask[:, :, None].to(x.dtype))
        for i, layer in enumerate(self.layers):
            x = layer(x, padding_mask, pre["biases"][i])
        x = self.layer_norm(x).to(cd)
        return {
            "encoder_out": x,
            "encoder_padding_mask": padding_mask,
            "image_embed_before_scale": image_embed_pre,
            "image_embed_shape": (h, w),
        }
