"""SegOFA model assembly.

``forward`` routes the main input (real image) through ``encode`` + decoder
and the ``aux_*`` input (artificial image) through ``encode_artificial`` +
decoder, with every bias built in the graph; the served forward
(``eval/serving.py``) runs over biases precomputed per checkpoint.

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

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "SegOFA":
        """Random weights from ``generator`` (a CPU generator), in a fixed
        module order: lecun-normal linears and convs with zero biases,
        normal(0, dim^-0.5) embeddings, normal(0, 0.1) relative-position
        tables; LayerNorms, FrozenBNs and head gains keep their identity
        values.  Returns self."""

        def normal_(t: torch.Tensor, std: float):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

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

    @torch.no_grad()
    def cast_for_serving(self, dtype: torch.dtype):
        """Cast, once, the weights the per-request forward multiplies with:
        the transformer layers' linears and ``image_proj`` to ``dtype``, and
        the ResNet's BN-folded convolutions (cached in ``dtype``).  Position
        linears, embeddings, LayerNorms and the seg head stay fp32, as the
        JAX package computes them."""
        mods = [self.encoder.image_proj]
        for layers in (self.encoder.layers, self.decoder.layers):
            mods += [m for m in layers.modules() if isinstance(m, Linear)]
        for m in mods:
            m.to(dtype)
        self.encoder.embed_images.fold(dtype)
        return self
