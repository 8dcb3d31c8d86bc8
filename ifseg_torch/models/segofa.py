"""SegOFA model assembly.

``forward`` routes the main input (real image) through ``encode`` + decoder
and the ``aux_*`` input (artificial image) through ``encode_artificial`` +
decoder, with every bias built in the graph; ``eval_forward`` is the
native-resolution evaluation forward over bucket-padded images; the served
forward (``eval/serving.py``) runs over biases precomputed per checkpoint.

One token embedding is shared by encoder and decoder (share_all_embeddings);
it appears in the state dict under both reference names,
``encoder.embed_tokens.weight`` and ``decoder.embed_tokens.weight``.
"""

import torch
from torch import nn

from ifseg_torch.config import ModelConfig
from .attention import Linear
from .decoder import Decoder
from .encoder import Encoder


class SegOFA(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        embed_tokens = nn.Embedding(cfg.vocab_size, cfg.encoder_embed_dim)
        self.encoder = Encoder(cfg, embed_tokens)
        self.decoder = Decoder(cfg, embed_tokens)

    def forward(self, src_tokens=None, patch_images=None, patch_masks=None, bos_tokens=None,
                aux_grid_ids=None, aux_src_tokens=None, class_tokens=None, class_lengths=None,
                full_context_alignment: bool = False):
        """Returns (logits, extra).  The main branch runs iff ``src_tokens`` is
        given; the aux (image-free) branch iff ``aux_grid_ids`` is, and puts
        its logits in ``extra["aux_output"]``."""
        logits = None
        extra = {}
        if src_tokens is not None:
            enc = self.encoder.encode(src_tokens, patch_images, patch_masks)
            logits = self.decoder(bos_tokens, enc, full_context_alignment)
            extra["encoder_returns"] = enc
        if aux_grid_ids is not None:
            aux_enc = self.encoder.encode_artificial(
                aux_src_tokens, aux_grid_ids, class_tokens, class_lengths
            )
            if bos_tokens is None:
                bos_tokens = torch.zeros(
                    aux_grid_ids.shape[0], 1, dtype=torch.long, device=aux_grid_ids.device
                )
            extra["aux_output"] = self.decoder(bos_tokens, aux_enc, full_context_alignment)
            extra["aux_encoder_returns"] = aux_enc
        return logits, extra

    def eval_forward(self, src_tokens, patch_images, img_h, img_w, bos_tokens,
                     full_context_alignment: bool = False):
        """Native-resolution evaluation forward over images zero-padded into
        a shape bucket (see ``Encoder.encode_padded``).  Returns (logits
        (B, 1 + Hp*Wp, C), encoder_out)."""
        enc = self.encoder.encode_padded(src_tokens, patch_images, img_h, img_w)
        return self.decoder(bos_tokens, enc, full_context_alignment), enc

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "SegOFA":
        """Random weights from ``generator``, drawn on its device (a CPU
        generator, or a CUDA one to build a large model on the card), in a
        fixed module order: lecun-normal linears and convs with zero biases,
        normal(0, dim^-0.5) embeddings, normal(0, 0.1) relative-position
        tables; LayerNorms, FrozenBNs and head gains keep their identity
        values.  Returns self."""

        def normal_(t: torch.Tensor, std: float):
            t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)

        for name, mod in self.named_modules():
            if isinstance(mod, Linear):
                normal_(mod.weight, mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                normal_(mod.weight, mod.weight[0].numel() ** -0.5)
            elif isinstance(mod, nn.Embedding):
                rel_table = "rel_pos_table_list" in name
                normal_(mod.weight, 0.1 if rel_table else mod.embedding_dim ** -0.5)
        return self

    def serving_linears(self):
        """The modules whose weights ``cast_for_serving`` casts: the
        transformer layers' linears and ``image_proj``."""
        mods = [self.encoder.image_proj]
        for layers in (self.encoder.layers, self.decoder.layers):
            mods += [m for m in layers.modules() if isinstance(m, Linear)]
        return mods

    @torch.no_grad()
    def cast_for_serving(self, dtype: torch.dtype):
        """Cast, once and in place, the weights the per-request forward
        multiplies with: the ``serving_linears`` to ``dtype``, and the
        ResNet's BN-folded convolutions (cached in ``dtype``).  Position
        linears, embeddings, LayerNorms and the seg head stay fp32, as the
        JAX package computes them.  A linear already quantized for int8
        serving (``ops.quantization.Int8Linear``) keeps its codes and fp32
        scales."""
        for m in self.serving_linears():
            if isinstance(m, Linear):
                m.to(dtype)
        self.encoder.embed_images.fold(dtype)
        return self
