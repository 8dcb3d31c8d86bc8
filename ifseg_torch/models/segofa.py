"""SegOFA model assembly, and ``build_generator``.

``forward`` routes the main input (real image) through ``encode`` + decoder
and the ``aux_*`` input (artificial image) through ``encode_artificial`` +
decoder, with every bias built in the graph; ``eval_forward`` is the
native-resolution evaluation forward over bucket-padded images; the served
forward (``eval/serving.py``) runs over biases precomputed per checkpoint.

One token embedding is shared by encoder and decoder (share_all_embeddings);
it appears in the state dict under both reference names,
``encoder.embed_tokens.weight`` and ``decoder.embed_tokens.weight``.

``build_generator`` (the JAX package's ``models/segofa.py:build_generator``)
wires the autoregressive
path into ``generate.SequenceGenerator``: beam search over the seg classes,
KV-cached (``models/ar_cache.py``) or by the full recompute
(``Decoder.decode_ar``), one model or an ensemble.
"""

from typing import Dict, Optional

import torch
from torch import nn

from ifseg_torch.config import ModelConfig
from .attention import Linear
from .decoder import Decoder
from .encoder import Encoder
from .moe_ffn import MoEFeedForward
from ifseg_torch.parallel.moe import init_moe_params


class SegOFA(nn.Module):
    """``plan``: the model axis's program (``parallel/plan.py``), or None."""

    def __init__(self, cfg: ModelConfig, plan=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        embed_tokens = nn.Embedding(cfg.vocab_size, cfg.encoder_embed_dim)
        self.encoder = Encoder(cfg, embed_tokens, plan)
        self.decoder = Decoder(cfg, embed_tokens, plan)

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

    def encode_only(self, src_tokens, patch_images, patch_masks: Optional[torch.Tensor] = None
                    ) -> Dict:
        """The encoder's real-image forward alone (``Encoder.encode``), as
        the JAX package's ``encode_only``."""
        return self.encoder.encode(src_tokens, patch_images, patch_masks)

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
        tables, the experts as ``parallel.moe.init_moe_params`` draws them;
        LayerNorms, FrozenBNs and head gains keep their identity values.
        Returns self."""

        def normal_(t: torch.Tensor, std: float):
            t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)

        for name, mod in self.named_modules():
            if isinstance(mod, Linear):
                # adapters: BERT-style N(0, 0.02), as the JAX package inits them
                normal_(mod.weight, 0.02 if ".adapter." in name else mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                normal_(mod.weight, mod.weight[0].numel() ** -0.5)
            elif isinstance(mod, nn.Embedding):
                rel_table = "rel_pos_table_list" in name
                normal_(mod.weight, 0.1 if rel_table else mod.embedding_dim ** -0.5)
            elif isinstance(mod, MoEFeedForward):
                e, d, f = mod.wi.shape
                for k, v in init_moe_params(generator, e, d, f).items():
                    getattr(mod, k).copy_(v)
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


def build_generator(model, encoder_out, beam: int = 5, max_len: int = 1022, min_len: int = 1022,
                    no_repeat_ngram_size: int = 0, use_kv_cache: bool = True,
                    constraint_trie=None, constraint_range=None, zero_shot: bool = False,
                    lexical_constraints=None):
    """A beam-search generator over the autoregressive decode (the JAX
    package's ``build_generator``; OFATask.build_generator,
    tasks/ofa_task.py:187-313; the seg eval args pin max_len == min_len).

    ``model`` is a ``SegOFA`` or a list of them (an ensemble, one weight set
    each, sharing a config): the generator then averages the members'
    next-token distributions in probability space (EnsembleModel,
    models/sequence_generator.py:899-900), each with its own cache.
    ``encoder_out`` is the encoder's output for the batch; its batch rows
    are tiled over the beam.  The vocabulary is the class ids [0, num_seg)
    plus two columns: EOS (num_seg, logit -1e4: never competitive, yet above
    the -1e9 of the last step's force mask) and pad / unk (num_seg + 1,
    logit -1e9, always banned); the dictionary's specials are class ids
    here and get no special treatment.  ``use_kv_cache`` steps through
    ``ar_step`` (refused for decoder prompts, adapters and scale_resids);
    otherwise each step recomputes the causal prefix by ``decode_ar``.  The
    defaults generate 1,022 tokens, the longest the token relative bias
    covers (``ar_cache.check_ar_length``; the JAX package's default of 1,024
    fails on a shape mismatch).  The generator runs on the encoder output's
    device; call it as ``gen(bsz, gen.initial_cache)``."""
    from ifseg_torch.generate.sequence_generator import SequenceGenerator, ensemble_step_fn
    from .ar_cache import ar_step, check_ar_length, init_ar_cache

    kwargs = dict(beam=beam, max_len=max_len, min_len=min_len,
                  no_repeat_ngram_size=no_repeat_ngram_size, use_kv_cache=use_kv_cache,
                  constraint_trie=constraint_trie, constraint_range=constraint_range,
                  zero_shot=zero_shot, lexical_constraints=lexical_constraints)
    if isinstance(model, (list, tuple)) and len(model) > 1:
        gens = [build_generator(m, encoder_out, **kwargs) for m in model]
        ens = gens[0]
        ens.step_fn = ensemble_step_fn([g.step_fn for g in gens])
        ens.initial_cache = tuple(g.initial_cache for g in gens)
        return ens
    if isinstance(model, (list, tuple)):
        model = model[0]
    check_ar_length(max_len + 2)

    bsz = encoder_out["encoder_out"].shape[0]
    enc_tiled = {k: v.repeat_interleave(beam, dim=0)
                 if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == bsz else v
                 for k, v in encoder_out.items()}
    num_seg = model.cfg.num_seg_tokens
    specials = dict(pad=num_seg + 1, eos=num_seg, unk=num_seg + 1, bos=0)

    def pad_logits(logits):
        cols = torch.full((logits.shape[0], 2), -1e4, dtype=logits.dtype, device=logits.device)
        cols[:, 1] = -1e9
        return torch.cat([logits, cols], dim=-1)

    if use_kv_cache:
        cache0 = init_ar_cache(model, enc_tiled, bsz * beam, max_len + 2)

        def step_fn(tokens, step, cache):
            logits, cache = ar_step(model, cache, tokens, step)
            return pad_logits(logits), cache
    else:
        cache0 = ()

        def step_fn(tokens, step, cache):
            logits = model.decoder.decode_ar(tokens, enc_tiled)
            return pad_logits(logits[:, min(step, tokens.shape[1] - 1)]), cache

    gen = SequenceGenerator(
        step_fn, vocab_size=num_seg + 2, beam_size=beam, **specials, max_len=max_len,
        min_len=min_len, no_repeat_ngram_size=no_repeat_ngram_size,
        constraint_trie=constraint_trie, constraint_range=constraint_range, zero_shot=zero_shot,
        lexical_constraints=lexical_constraints, device=encoder_out["encoder_out"].device)
    gen.initial_cache = cache0
    return gen
