"""Pre-LN transformer layers with the OFA extras.

Mirrors models/segofa/unify_transformer_layer.py as the JAX package's
``models/layers.py`` computes it: ``attn_ln`` after self-attention
("scale_attn"), ``ffn_layernorm`` between the FFN products ("scale_fc") and
optional ``w_resid`` residual scaling ("scale_resids").  LayerNorms compute
their row statistics in fp32 and write the compute dtype.  Dropout (after
attention, after the FFN and on the FFN activation) and DropPath follow
``module.training`` and draw from an explicit ``torch.Generator``
(``attention.set_generator``); in eval mode they are the identity.
``Adapter`` (a bottleneck on the FFN output before the residual) and
``PromptEncoder`` (the per-layer key/value prefixes of prefix tuning) are the
option paths of unify_transformer_layer.py:49-94 and encoder_module.py:989-1027.
A layer built with ``use_moe`` (``moe_layer``: every ``moe_freq``-th one
under ``--moe-experts``) holds ``moe`` (``models/moe_ffn.py``) in place of
fc1, the FFN LayerNorm and fc2, as the JAX package's layer holds ``moe`` in
place of ``ffn``; its output has no dropout, as there.  Self-attention takes
the plan (``plan=``) for ring attention under ``--context-parallel``.

``run_layer`` runs a layer under activation checkpointing where the model
config asks for it (``checkpoint_activations``, ``remat_policy``) and a
gradient flows: ``torch.utils.checkpoint`` without re-entry, so the forward
and its recompute both take the gradient route of LayerNorm and attention.
The recompute replays the layer's dropout and DropPath masks from the
generator state its forward began with, then puts back the state the
forward left, so a checkpointed step equals an unchecked one bit for bit
and draws nothing extra.  ``save-attn`` keeps each attention's (out, lse)
(the dispatched op ``ops.flash_attention.ATTN_FWD_STATS_OP``) and
``save-attn-ffn`` also the FFN activation; ``full`` recomputes everything.

Parameter names are the reference torch names (``self_attn.q_proj``,
``fc1``, ``ffn_layernorm``, ``final_layer_norm``, ...), so a layer loads a
reference state dict as it is.
"""

from contextlib import contextmanager, nullcontext

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ifseg_torch.ops.flash_attention import ATTN_FWD_STATS_OP
from ifseg_torch.ops.gelu import gelu_poly
from ifseg_torch.ops.layer_norm import fused_layer_norm
from .attention import Dropout, Linear, MultiheadAttention
from .moe_ffn import MoEFeedForward

REMAT_POLICIES = ("full", "save-attn", "save-attn-ffn")
# the ops whose outputs a policy saves; the FFN activation is the output of
# the activation function (gelu or relu)
_SAVED_OPS = {
    "full": frozenset(),
    "save-attn": frozenset({ATTN_FWD_STATS_OP}),
    "save-attn-ffn": frozenset({ATTN_FWD_STATS_OP, torch.ops.aten.gelu.default,
                                torch.ops.aten.relu.default}),
}


def _context_fn(generator, policy: str):
    """checkpoint's context pair: the forward records ``generator``'s state;
    the recompute replays from it and restores the state it found.  Under a
    saving policy both also run the selective-checkpoint modes."""
    saved = _SAVED_OPS[policy]

    def decide(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn():
        fwd, rec = (create_selective_checkpoint_contexts(decide) if saved
                    else (nullcontext(), nullcontext()))
        start = {}

        @contextmanager
        def forward():
            start["state"] = None if generator is None else generator.get_state()
            with fwd:
                yield

        @contextmanager
        def recompute():
            found = None if generator is None else generator.get_state()
            if generator is not None:
                generator.set_state(start["state"])
            try:
                with rec:
                    yield
            finally:
                if generator is not None:
                    generator.set_state(found)

        return forward(), recompute()

    return context_fn


def run_layer(layer: nn.Module, cfg, *args):
    """``layer(*args)``, checkpointed under ``cfg.checkpoint_activations``
    when a gradient flows (see the module docstring).  An unresolved "auto"
    takes save-attn, as the JAX package does."""
    if not (cfg.checkpoint_activations and torch.is_grad_enabled()):
        return layer(*args)
    policy = "save-attn" if cfg.remat_policy == "auto" else cfg.remat_policy
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: take auto, {', '.join(REMAT_POLICIES)}")
    generator = next((m.generator for m in layer.modules()
                      if getattr(m, "generator", None) is not None), None)
    return checkpoint(layer, *args, use_reentrant=False,
                      context_fn=_context_fn(generator, policy))


class DropPath(nn.Module):
    """Stochastic depth, dropped per sample (unify_transformer_layer.py:19-35):
    ``x / keep * floor(keep + u)`` with one uniform ``u`` per batch row."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return x / keep * torch.floor(keep + u).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis (eps 1e-5): fp32 row statistics, output
    written in ``out_dtype`` (fp32 unless the caller names its compute dtype).

    Where no gradient is needed (serving, evaluation, the trainer's
    monitoring forward) it is ``ops.layer_norm.fused_layer_norm``: flax's
    fast variance E[x²]−E[x]², by the one-pass Hopper kernel on a CUDA tensor
    and by its plain version on a CPU tensor.  Where a gradient flows it is
    ``F.layer_norm`` in fp32 and a cast, on both devices: the fused op's
    backward is plain math, about ten elementwise passes a site against one
    fused backward here.  That route keeps PyTorch's two-pass variance
    E[(x−E[x])²], so under gradients the port still differs from flax's
    formula in the last bits of fp32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x, out_dtype=torch.float32):
        if torch.is_grad_enabled() and (
            x.requires_grad or self.weight.requires_grad or self.bias.requires_grad
        ):
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
            return y.to(out_dtype)
        return fused_layer_norm(x, self.weight, self.bias, self.eps, out_dtype)


ACTIVATIONS = {
    "gelu": F.gelu,  # fairseq's gelu: the exact erf form
    "gelu_exact": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_poly": gelu_poly,
    "relu": F.relu,
}


class Adapter(nn.Module):
    """Bottleneck adapter (unify_transformer_layer.py:49-94): x +
    up_proj(relu(down_proj(x))), on the FFN output before the residual add.
    ``SegOFA.init`` draws both kernels from N(0, 0.02) with zero biases, the
    BERT-style init of the JAX package."""

    def __init__(self, embed_dim: int, down_size: int):
        super().__init__()
        self.down_proj = Linear(embed_dim, down_size)
        self.up_proj = Linear(down_size, embed_dim)

    def forward(self, x):
        return x + self.up_proj(F.relu(self.down_proj(x)))


class PromptEncoder(nn.Module):
    """Prefix-tuning prompt generator (encoder_module.py:989-1027): a learned
    table of per-layer key/value prefixes, (layers, 2, heads, P, head_dim)
    fp32.  The reference expands the same ``arange(P)`` ids over the batch,
    so the prefix is batch-independent: computed once a forward and broadcast
    inside attention.  With ``projection`` the table is P rows of
    ``embed_dim`` through ``trans`` (Linear, ReLU, Linear to layers·2·D, the
    hidden width ``proj_dim`` or 2·D); without, P rows of layers·2·D.
    Dropout 0.2 on the result (the reference's p=0.2 on past_key_values),
    from the port's generator (``attention.set_generator``).  Parameter names
    are the reference's: ``embedding.weight``, ``trans.{0,2}.{weight,bias}``."""

    def __init__(self, length: int, embed_dim: int, num_layers: int, num_heads: int,
                 projection: bool = False, proj_dim: int = 0, dropout: float = 0.2):
        super().__init__()
        self.length, self.num_layers, self.num_heads = length, num_layers, num_heads
        self.head_dim = embed_dim // num_heads
        out_dim = num_layers * 2 * embed_dim
        if projection:
            self.embedding = nn.Embedding(length, embed_dim)
            hidden = proj_dim or 2 * embed_dim
            self.trans = nn.Sequential(Linear(embed_dim, hidden), nn.ReLU(), Linear(hidden, out_dim))
        else:
            self.embedding = nn.Embedding(length, out_dim)
            self.trans = None
        self.dropout = Dropout(dropout)

    def forward(self):
        x = self.embedding.weight
        if self.trans is not None:
            x = self.trans(x)
        x = self.dropout(x)
        # (P, 2L·H·dh) -> (P, 2L, H, dh) -> (2L, H, P, dh) -> (L, 2, H, P, dh)
        x = x.reshape(self.length, self.num_layers * 2, self.num_heads, self.head_dim)
        return x.permute(1, 2, 0, 3).reshape(
            self.num_layers, 2, self.num_heads, self.length, self.head_dim)


def moe_layer(plan, i: int) -> bool:
    """Whether layer ``i`` holds experts: every ``plan.moe_freq``-th layer
    under more than one expert (the JAX package's ``_moe_layer``)."""
    return (plan is not None and plan.moe_experts > 1
            and i % plan.moe_freq == plan.moe_freq - 1)


class FeedForward(nn.Module):
    """fc1 -> activation -> ffn_layernorm (scale_fc) -> fc2, or with
    ``plan`` the BASE experts (``MoEFeedForward``).

    The layers below inherit it, so its parameters sit on the layer under the
    reference names (``layers.{i}.fc1``, not ``layers.{i}.ffn.fc1``)."""

    def __init__(self, embed_dim: int, ffn_dim: int, activation_fn: str = "gelu_tanh",
                 scale_fc: bool = True, dropout: float = 0.0, activation_dropout: float = 0.0,
                 drop_path_rate: float = 0.0, use_adapter: bool = False, adapter_dim: int = 200,
                 moe_plan=None):
        super().__init__()
        if activation_fn not in ACTIVATIONS:
            raise NotImplementedError(f"activation {activation_fn!r} is not ported")
        self.act = ACTIVATIONS[activation_fn]
        self.dropout = Dropout(dropout)
        self.activation_dropout = Dropout(activation_dropout)
        self.drop_path = DropPath(drop_path_rate)
        if moe_plan is None:
            self.moe = None
            self.fc1 = Linear(embed_dim, ffn_dim)
            self.fc2 = Linear(ffn_dim, embed_dim)
            self.ffn_layernorm = LayerNorm(ffn_dim) if scale_fc else None
        else:
            self.moe = MoEFeedForward(embed_dim, ffn_dim, moe_plan)
            self.fc1 = self.fc2 = self.ffn_layernorm = None
        self.adapter = Adapter(embed_dim, adapter_dim) if use_adapter else None

    def ffn(self, x):
        """The FFN (or the experts), then the adapter where there is one."""
        if self.moe is not None:
            y = self.moe(x)
        else:
            y = self.activation_dropout(self.act(self.fc1(x)))
            if self.ffn_layernorm is not None:
                y = self.ffn_layernorm(y, x.dtype)
            y = self.dropout(self.fc2(y))
        return y if self.adapter is None else self.adapter(y)


class EncoderLayer(FeedForward):
    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 attn_scale_factor: float = 2.0, scale_attn: bool = True,
                 scale_fc: bool = True, scale_heads: bool = True,
                 scale_resids: bool = False, activation_fn: str = "gelu_tanh",
                 use_adapter: bool = False, adapter_dim: int = 200, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 drop_path_rate: float = 0.0, use_flash: bool = True, plan=None,
                 use_moe: bool = False):
        super().__init__(embed_dim, ffn_dim, activation_fn, scale_fc, dropout,
                         activation_dropout, drop_path_rate, use_adapter, adapter_dim,
                         plan if use_moe else None)
        self.self_attn = MultiheadAttention(embed_dim, num_heads, attn_scale_factor, scale_heads,
                                            attention_dropout, use_flash, plan)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.attn_ln = LayerNorm(embed_dim) if scale_attn else None
        self.final_layer_norm = LayerNorm(embed_dim)
        self.w_resid = nn.Parameter(torch.ones(embed_dim)) if scale_resids else None

    def forward(self, x, padding_mask=None, self_attn_bias=None, prompt_kv=None):
        dt = x.dtype
        residual = x
        y = self.self_attn_layer_norm(x, dt)
        y = self.self_attn(y, bias=self_attn_bias, key_padding_mask=padding_mask,
                           prompt_kv=prompt_kv)
        if self.attn_ln is not None:
            y = self.attn_ln(y, dt)
        x = residual + self.drop_path(self.dropout(y))

        residual = x
        y = self.ffn(self.final_layer_norm(x, dt))
        if self.w_resid is not None:
            residual = residual * self.w_resid.to(dt)
        return residual + self.drop_path(y)


class DecoderLayer(FeedForward):
    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 attn_scale_factor: float = 2.0, scale_attn: bool = True,
                 scale_fc: bool = True, scale_heads: bool = True,
                 scale_resids: bool = False, activation_fn: str = "gelu_tanh",
                 use_adapter: bool = False, adapter_dim: int = 200, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 drop_path_rate: float = 0.0, use_flash: bool = True, plan=None,
                 use_moe: bool = False):
        super().__init__(embed_dim, ffn_dim, activation_fn, scale_fc, dropout,
                         activation_dropout, drop_path_rate, use_adapter, adapter_dim,
                         plan if use_moe else None)
        self.self_attn = MultiheadAttention(embed_dim, num_heads, attn_scale_factor, scale_heads,
                                            attention_dropout, use_flash, plan)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.self_attn_ln = LayerNorm(embed_dim) if scale_attn else None
        self.encoder_attn = MultiheadAttention(embed_dim, num_heads, attn_scale_factor,
                                               scale_heads, attention_dropout, use_flash)
        self.encoder_attn_layer_norm = LayerNorm(embed_dim)
        self.cross_attn_ln = LayerNorm(embed_dim) if scale_attn else None
        self.final_layer_norm = LayerNorm(embed_dim)
        self.w_resid = nn.Parameter(torch.ones(embed_dim)) if scale_resids else None

    def forward(self, x, encoder_out=None, encoder_padding_mask=None,
                self_attn_bias=None, cross_attn_bias=None, self_padding_mask=None,
                causal: bool = True, prompt_kv=None):
        dt = x.dtype
        residual = x
        y = self.self_attn_layer_norm(x, dt)
        y = self.self_attn(y, bias=self_attn_bias, key_padding_mask=self_padding_mask,
                           causal=causal, prompt_kv=prompt_kv)
        if self.self_attn_ln is not None:
            y = self.self_attn_ln(y, dt)
        x = residual + self.drop_path(self.dropout(y))

        if encoder_out is not None:
            residual = x
            y = self.encoder_attn_layer_norm(x, dt)
            y = self.encoder_attn(y, key=encoder_out, bias=cross_attn_bias,
                                  key_padding_mask=encoder_padding_mask)
            if self.cross_attn_ln is not None:
                y = self.cross_attn_ln(y, dt)
            x = residual + self.drop_path(self.dropout(y))

        residual = x
        y = self.ffn(self.final_layer_norm(x, dt))
        if self.w_resid is not None:
            residual = residual * self.w_resid.to(dt)
        return residual + self.drop_path(y)
