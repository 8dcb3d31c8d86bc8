"""SegOFA encoder: ResNet image stem + token path + OFA transformer stack.

Mirrors models/segofa/encoder_module.py as the JAX package's ``Encoder``
computes it.  The sequence order is [image ‖ text].  Every attention bias
and position embedding depends only on the parameters and the input shape.
Serving builds them once per checkpoint (``precompute_biases``, one (layers,
H, L, L) pack in compute dtype) and runs the per-request part
(``encode_served``).  Training builds the same pack inside the graph
(``_run_layers``), so the position parameters get their gradients through
the attention kernels' dbias: ``encode`` is the real-image forward and
``encode_artificial`` the image-free one, whose image tokens are the
per-class mean embeddings of the category words laid out on a grid.

With ``encoder_prompt`` (prefix tuning) ``encoder_prompt_encoder`` makes the
per-layer key/value prefixes once a forward, and every layer of the three
in-graph forwards prepends its own; the pack is then allocated (layers, H,
L, P + L) with the P prefix columns zero.  ``encode_served`` applies no
prefix, as the JAX package's ``encode_served`` applies none
(``ifseg_tpu/models/encoder.py:520-537`` against ``_run_layers`` :291-295):
a prompt-tuned model served by ``SegServer`` answers without its prefixes
while its evaluator and trainer apply them (ROADMAP.md C.4).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ifseg_torch.config import ModelConfig
from ifseg_torch.ops.flash_attention import row_padded
from ifseg_torch.ops.resize import bilinear_dyn_tensor, resize_bilinear
from .attention import Dropout, Linear, prefixed_pack
from .layers import EncoderLayer, LayerNorm, PromptEncoder, run_layer
from .position import (
    gather_grid_bias_all_layers,
    gather_rel_bias_all_layers,
    image_grid_position_ids,
    image_num_rel_dis,
    image_rel_bucket_direct,
    image_rp_bucket_for_grid,
    interp_grid_bias,
    interp_grid_bias_mats,
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


class LayerDrop(nn.Module):
    """LayerDrop (fairseq LayerDropModuleList): in training, keep a whole
    layer's output with probability 1 - rate, else pass its input on.  The
    layer is computed either way and the choice is a ``where`` on the
    device, as in the JAX package, so no step waits for the host."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x_new, x_old):
        if not self.training or self.rate == 0.0:
            return x_new
        keep = torch.rand((), generator=self.generator, device=x_new.device) < 1.0 - self.rate
        return torch.where(keep, x_new, x_old)


def class_mean_embeddings(embed_table, class_tokens, class_lengths):
    """Per-class mean of category-word token embeddings (EmbeddingBag mean
    mode, encoder_module.py:147-148).  embed_table (V, D); class_tokens
    (C, T) padded ids; class_lengths (C,)."""
    emb = embed_table[class_tokens]  # (C, T, D)
    t = class_tokens.shape[1]
    steps = torch.arange(t, device=class_tokens.device)
    mask = (steps[None, :] < class_lengths[:, None]).to(emb.dtype)
    summed = (emb * mask[:, :, None]).sum(1)
    return summed / class_lengths[:, None].to(emb.dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, embed_tokens: nn.Embedding):
        super().__init__()
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
                use_adapter=cfg.adapter, adapter_dim=cfg.adapter_dim,
                dropout=cfg.dropout, attention_dropout=cfg.attention_dropout,
                activation_dropout=cfg.activation_dropout, drop_path_rate=float(rate),
                use_flash=cfg.use_flash_attention,
            )
            for rate in np.linspace(0, cfg.encoder_drop_path_rate, nl)
        )
        self.layer_norm = LayerNorm(d)
        self.dropout_layer = Dropout(cfg.dropout)
        self.layerdrop = LayerDrop(cfg.encoder_layerdrop)
        self.encoder_prompt_encoder = PromptEncoder(
            cfg.encoder_prompt_length, d, nl, heads, cfg.encoder_prompt_projection,
            cfg.encoder_prompt_dim) if cfg.encoder_prompt else None

    def prompt_kv_all(self) -> Optional[torch.Tensor]:
        """(layers, 2, H, P, dh) prefix key/values, or None without prefix
        tuning (encoder_module.py:510-521)."""
        if self.encoder_prompt_encoder is None or self.cfg.encoder_prompt_type != "prefix":
            return None
        return self.encoder_prompt_encoder()

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
        hw = image_hw[0] * image_hw[1]
        t = src_len
        pos_all = self._pos_all(src_len, image_hw)

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
        return {"pos_all": pos_all, "biases": row_padded(torch.stack(biases))}

    def _text_embed(self, src_tokens):
        """Token path: embed + type(0) + LN + dropout (encoder_module.py:573-586)."""
        cd = compute_dtype(self.cfg)
        x = self.embed_tokens(src_tokens).to(cd)
        if self.type_embedding is not None:
            x = x + self.type_embedding.weight[0].to(cd)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x, cd)
        return self.dropout_layer(x)

    def _image_token_embed(self, image_embed):
        """Image path: + type(1) + patch LN + dropout (encoder_module.py:589-600)."""
        cd = compute_dtype(self.cfg)
        x = image_embed.to(cd)
        if self.type_embedding is not None:
            x = x + self.type_embedding.weight[1].to(cd)
        if self.patch_layernorm_embedding is not None:
            x = self.patch_layernorm_embedding(x, cd)
        return self.dropout_layer(x)

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
        # no prefix here, as in the JAX package's encode_served (see the
        # module docstring): ifseg_tpu/models/encoder.py:535-536
        for i, layer in enumerate(self.layers):
            x = layer(x, padding_mask, pre["biases"][i])
        x = self.layer_norm(x, cd)
        return {
            "encoder_out": x,
            "encoder_padding_mask": padding_mask,
            "image_embed_before_scale": image_embed_pre,
            "image_embed_shape": (h, w),
        }

    # ------------------------------------------------- forward with in-graph biases

    def _pos_all(self, src_len: int, image_hw: Tuple[int, int],
                 pos_img: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(L, D) fp32 post-LN position embeddings, [image ‖ text]."""
        dev = self.pos_ln.weight.device
        pos_text = self.pos_ln(self.embed_positions(torch.arange(src_len, device=dev)))
        if pos_img is None:
            pos_img = self.image_pos_ln(self._image_pos_embed(*image_hw))
        return torch.cat([pos_img, pos_text], dim=0)

    def _run_layers(self, x, padding_mask, pos_all, src_len: int, image_hw: Tuple[int, int],
                    rel_bias_grid_hw: Optional[Tuple[int, int]] = None,
                    img_all: Optional[torch.Tensor] = None):
        """The layer stack over an all-layer bias pack (layers, H, L, L) built
        here, in the graph and in compute dtype: abs bias + token rel bias on
        the text block + image rel bias on the image block.  The image bias
        is ``img_all`` (layers, H, hw, hw) when the caller built it (padded
        evaluation), else the gather over the ``rel_bias_grid_hw`` grid,
        interpolated when the runtime grid differs.  Each component is cast
        before the adds; the casts' backward returns the table gradients to
        fp32.  The pack is summed in the graph into row-padded storage (rows
        a multiple of 8 keys apart), so the kernels fetch every layer's bias
        by TMA whatever L is: the abs bias into every layer, then the two
        relative blocks added where they belong (the same sums as padding
        each block to (L, L) with zeros, without those temporaries).  Under
        prefix tuning the pack is (layers, H, L, P + L), its first P columns
        zero, and each layer prepends its prefix (``prompt_kv_all``, made
        once here, outside the checkpointed layers, so its dropout draws once
        a forward)."""
        cfg = self.cfg
        cd = compute_dtype(cfg)
        hw = image_hw[0] * image_hw[1]
        bias0 = self._abs_bias(pos_all)
        token_bucket = make_token_bucket_position(cfg.token_bucket_size)[:src_len, :src_len]
        tok_all = gather_rel_bias_all_layers(
            stack_tables(self.token_rel_pos_table_list), token_bucket
        )
        if img_all is None:
            image_bucket = image_rp_bucket_for_grid(*rel_bias_grid_hw, cfg.image_bucket_size)
            ident_interp = tuple(rel_bias_grid_hw) == tuple(image_hw)
            img_all = gather_grid_bias_all_layers(
                stack_tables(self.image_rel_pos_table_list), image_bucket, rel_bias_grid_hw,
                dtype=cd if ident_interp else torch.float32,
            )
            if not ident_interp:
                img_all = torch.stack(
                    [interp_grid_bias(b, rel_bias_grid_hw, image_hw) for b in img_all]
                )
        prompts = self.prompt_kv_all()
        p = 0 if prompts is None else prompts.shape[3]
        pack, body = prefixed_pack((tok_all.shape[0], *bias0.shape), p, cd, bias0.device)
        body.copy_(bias0.to(cd))
        body[..., hw:, hw:].add_(tok_all.to(cd))
        body[..., :hw, :hw].add_(img_all.to(cd))
        for i, (layer, bias) in enumerate(zip(self.layers, pack.unbind(0))):
            args = (x, padding_mask, bias) + (() if prompts is None else (prompts[i],))
            x = self.layerdrop(run_layer(layer, cfg, *args), x)
        return self.layer_norm(x, cd)

    def _encode_tokens(self, src_tokens, image_embed, image_pad, image_hw, rel_bias_grid_hw,
                       resnet_feats=None, pos_img=None, img_all=None) -> Dict:
        """The token path shared by the three forwards.  ``pos_img`` (hw, D)
        post-LN image position embeddings and ``img_all`` (layers, H, hw, hw)
        image relative bias override what the grid alone gives (padded
        evaluation)."""
        padding_mask = torch.cat([image_pad, src_tokens == PAD], dim=1)
        x = torch.cat(
            [self._image_token_embed(image_embed), self._text_embed(src_tokens)], dim=1
        )
        x = x * (1.0 - padding_mask[:, :, None].to(x.dtype))
        t = src_tokens.shape[1]
        pos_all = self._pos_all(t, image_hw, pos_img)
        x = self._run_layers(x, padding_mask, pos_all, t, image_hw, rel_bias_grid_hw, img_all)
        return {
            "encoder_out": x,
            "encoder_padding_mask": padding_mask,
            "position_embeddings": pos_all,
            "image_embed_before_scale": image_embed,
            "image_embed_before_proj": resnet_feats,
            "image_embed_shape": tuple(image_hw),
        }

    def encode(self, src_tokens, patch_images, patch_masks: Optional[torch.Tensor] = None) -> Dict:
        """Real-image forward (encoder_module.py:677-851).  src_tokens (B, T);
        patch_images (B, H, W, 3) normalized; patch_masks (B,) bool."""
        cfg = self.cfg
        feats = self.embed_images(patch_images.to(compute_dtype(cfg)))
        b, h, w, _ = feats.shape
        resnet_feats = feats.reshape(b, h * w, -1)
        image_embed = self.image_proj(resnet_feats)
        image_pad = torch.zeros(b, h * w, dtype=torch.bool, device=src_tokens.device)
        if patch_masks is not None:
            image_pad = image_pad | (~patch_masks)[:, None]
        orig_hw = cfg.orig_patch_image_size // 16
        return self._encode_tokens(src_tokens, image_embed, image_pad, (h, w),
                                   (orig_hw, orig_hw), resnet_feats)

    def encode_padded(self, src_tokens, patch_images, img_h, img_w) -> Dict:
        """Native-resolution evaluation forward (the JAX package's
        ``encode_padded``).  ``patch_images`` (B, Hb, Wb, 3) are normalized
        images zero-padded into a shape bucket; ``img_h`` / ``img_w`` are the
        valid pixel extents, ints or (B,) integer arrays.  Per-row extents
        feed only the stem's masking: positions and biases depend on the
        ceil-16 patch extents, which the rows of one group share, so they are
        built once for the batch.  The stem masks its padding, the position
        embeddings and the image relative bias come from dynamic-valid
        interpolation matrices (grids larger than the pretraining grid) or
        from direct lookups (smaller ones), and padded patch tokens are
        masked out of attention, so the valid tokens' outputs equal the
        unpadded forward's.  Returns ``encode``'s dictionary plus
        ``valid_hw`` (hp, wp) and ``grid_valid`` (Hp*Wp,) bool."""
        cfg = self.cfg
        dev = src_tokens.device
        img_h, img_w = np.asarray(img_h), np.asarray(img_w)
        to_dev = lambda v: int(v) if v.ndim == 0 else torch.from_numpy(v.astype(np.int64)).to(dev)
        feats = self.embed_images(patch_images.to(compute_dtype(cfg)),
                                  valid_hw=(to_dev(img_h), to_dev(img_w)))
        b, Hp, Wp, _ = feats.shape
        hw = Hp * Wp
        hp, wp = -(-int(img_h.max()) // 16), -(-int(img_w.max()) // 16)
        resnet_feats = feats.reshape(b, hw, -1)
        image_embed = self.image_proj(resnet_feats)

        cell = np.arange(hw)
        r, c = cell // Wp, cell % Wp
        grid_valid = torch.from_numpy((r < hp) & (c < wp)).to(dev)
        image_pad = (~grid_valid)[None, :].expand(b, hw)

        bucket = cfg.image_bucket_size
        orig_hw = cfg.orig_patch_image_size // 16
        tables = stack_tables(self.image_rel_pos_table_list)
        if hp * wp > orig_hw * orig_hw:  # interpolate from the pretraining grid
            ah = bilinear_dyn_tensor(orig_hw, Hp, hp, device=dev)
            aw = bilinear_dyn_tensor(orig_hw, Wp, wp, device=dev)
            ids = image_grid_position_ids(orig_hw, orig_hw, bucket)
            pe = self.embed_image_positions(_ids(ids, dev)).reshape(orig_hw, orig_hw, -1)
            pe = torch.einsum("Hi,ijd->Hjd", ah, pe.float())
            pos_img = torch.einsum("Wj,Hjd->HWd", aw, pe).reshape(hw, -1)
            orig_bucket = image_rp_bucket_for_grid(orig_hw, orig_hw, bucket)
            img_all = torch.stack([
                interp_grid_bias_mats(bias, ah, aw, (orig_hw, orig_hw))
                for bias in gather_rel_bias_all_layers(tables, orig_bucket)
            ])
        else:  # look the padded grid's cells up directly
            ids = np.clip(r * bucket + c + 1, 0, bucket**2)
            pos_img = self.embed_image_positions(_ids(ids, dev)).float()
            img_all = gather_rel_bias_all_layers(
                tables, image_rel_bucket_direct(Hp, Wp, bucket))
        out = self._encode_tokens(src_tokens, image_embed, image_pad, (Hp, Wp), None,
                                  resnet_feats, self.image_pos_ln(pos_img), img_all)
        out["valid_hw"] = (hp, wp)
        out["grid_valid"] = grid_valid
        return out

    def encode_artificial(self, src_tokens, grid_ids, class_tokens, class_lengths) -> Dict:
        """Artificial-image forward (encoder_module.py:499-675).  grid_ids
        (B, hw) class ids in [0, num_classes); class_tokens (C, Tname) padded
        category-word token ids; class_lengths (C,)."""
        h = w = self.cfg.patch_image_size // 16
        class_embeds = class_mean_embeddings(self.embed_tokens.weight, class_tokens, class_lengths)
        image_embed = class_embeds[grid_ids]  # (B, hw, D)
        image_pad = torch.zeros(grid_ids.shape, dtype=torch.bool, device=src_tokens.device)
        return self._encode_tokens(src_tokens, image_embed, image_pad, (h, w), (h, w))
