"""Pre-LN transformer layers with the OFA extras, for the served forward.

Mirrors models/segofa/unify_transformer_layer.py as the JAX package's
``models/layers.py`` computes it: ``attn_ln`` after self-attention
("scale_attn"), ``ffn_layernorm`` between the FFN products ("scale_fc") and
optional ``w_resid`` residual scaling ("scale_resids").  LayerNorms run in
fp32 and are cast back to the compute dtype.  Dropout, DropPath, adapters and
MoE are training or option paths that the served forward does not run.

Parameter names are the reference torch names (``self_attn.q_proj``,
``fc1``, ``ffn_layernorm``, ``final_layer_norm``, ...), so a layer loads a
reference state dict as it is.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .attention import Linear, MultiheadAttention


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in fp32 (eps 1e-5), fp32 output.

    Uses ``F.layer_norm`` (two-pass variance) where flax computes the fast
    variance E[x²]−E[x]²; the served-forward parity test bounds the
    difference."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


_ACTIVATIONS = {
    "gelu": F.gelu,  # fairseq's gelu: the exact erf form
    "gelu_exact": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


class FeedForward(nn.Module):
    """fc1 -> activation -> ffn_layernorm (scale_fc) -> fc2.

    The layers below inherit it, so its parameters sit on the layer under the
    reference names (``layers.{i}.fc1``, not ``layers.{i}.ffn.fc1``)."""

    def __init__(self, embed_dim: int, ffn_dim: int, activation_fn: str = "gelu_tanh",
                 scale_fc: bool = True):
        super().__init__()
        if activation_fn not in _ACTIVATIONS:
            raise NotImplementedError(f"activation {activation_fn!r} is not ported")
        self.act = _ACTIVATIONS[activation_fn]
        self.fc1 = Linear(embed_dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, embed_dim)
        self.ffn_layernorm = LayerNorm(ffn_dim) if scale_fc else None

    def ffn(self, x):
        y = self.act(self.fc1(x))
        if self.ffn_layernorm is not None:
            y = self.ffn_layernorm(y).to(x.dtype)
        return self.fc2(y)


class EncoderLayer(FeedForward):
    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 attn_scale_factor: float = 2.0, scale_attn: bool = True,
                 scale_fc: bool = True, scale_heads: bool = True,
                 scale_resids: bool = False, activation_fn: str = "gelu_tanh",
                 use_adapter: bool = False):
        if use_adapter:
            raise NotImplementedError("adapters are not ported")
        super().__init__(embed_dim, ffn_dim, activation_fn, scale_fc)
        self.self_attn = MultiheadAttention(embed_dim, num_heads, attn_scale_factor, scale_heads)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.attn_ln = LayerNorm(embed_dim) if scale_attn else None
        self.final_layer_norm = LayerNorm(embed_dim)
        self.w_resid = nn.Parameter(torch.ones(embed_dim)) if scale_resids else None

    def forward(self, x, padding_mask=None, self_attn_bias=None):
        dt = x.dtype
        residual = x
        y = self.self_attn_layer_norm(x).to(dt)
        y = self.self_attn(y, bias=self_attn_bias, key_padding_mask=padding_mask)
        if self.attn_ln is not None:
            y = self.attn_ln(y).to(dt)
        x = residual + y

        residual = x
        y = self.ffn(self.final_layer_norm(x).to(dt))
        if self.w_resid is not None:
            residual = residual * self.w_resid.to(dt)
        return residual + y


class DecoderLayer(FeedForward):
    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 attn_scale_factor: float = 2.0, scale_attn: bool = True,
                 scale_fc: bool = True, scale_heads: bool = True,
                 scale_resids: bool = False, activation_fn: str = "gelu_tanh",
                 use_adapter: bool = False):
        if use_adapter:
            raise NotImplementedError("adapters are not ported")
        super().__init__(embed_dim, ffn_dim, activation_fn, scale_fc)
        self.self_attn = MultiheadAttention(embed_dim, num_heads, attn_scale_factor, scale_heads)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.self_attn_ln = LayerNorm(embed_dim) if scale_attn else None
        self.encoder_attn = MultiheadAttention(embed_dim, num_heads, attn_scale_factor, scale_heads)
        self.encoder_attn_layer_norm = LayerNorm(embed_dim)
        self.cross_attn_ln = LayerNorm(embed_dim) if scale_attn else None
        self.final_layer_norm = LayerNorm(embed_dim)
        self.w_resid = nn.Parameter(torch.ones(embed_dim)) if scale_resids else None

    def forward(self, x, encoder_out=None, encoder_padding_mask=None,
                self_attn_bias=None, cross_attn_bias=None, self_padding_mask=None,
                causal: bool = True):
        dt = x.dtype
        residual = x
        y = self.self_attn_layer_norm(x).to(dt)
        y = self.self_attn(y, bias=self_attn_bias, key_padding_mask=self_padding_mask,
                           causal=causal)
        if self.self_attn_ln is not None:
            y = self.self_attn_ln(y).to(dt)
        x = residual + y

        if encoder_out is not None:
            residual = x
            y = self.encoder_attn_layer_norm(x).to(dt)
            y = self.encoder_attn(y, key=encoder_out, bias=cross_attn_bias,
                                  key_padding_mask=encoder_padding_mask)
            if self.cross_attn_ln is not None:
                y = self.cross_attn_ln(y).to(dt)
            x = residual + y

        residual = x
        y = self.ffn(self.final_layer_norm(x).to(dt))
        if self.w_resid is not None:
            residual = residual * self.w_resid.to(dt)
        return residual + y
