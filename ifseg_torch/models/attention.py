"""Multi-head attention with additive position bias and per-head gains.

The math of models/segofa/unify_multihead_attention.py, as the JAX package's
``models/attention.py`` computes it:
  - q scaled by (head_dim * scale_factor) ** -0.5 on the projection output,
    in compute dtype;
  - an additive (H, Lq, Lk) bias shared across the batch;
  - a key-padding mask and causal masking with the offset lk - lq;
  - an optional per-head gain ``c_attn`` ("scale_heads").

Batch-major (B, L, D).  The attention itself is
``ops.flash_attention.flash_attention_bias_packed_infer``: the Hopper kernel
for CUDA tensors, its plain version for CPU tensors.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ifseg_torch.ops.flash_attention import flash_attention_bias_packed_infer


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype: fp32 params are cast at
    use, as flax's ``Dense(dtype=...)`` does (a no-op once a server has cast
    the weights to compute dtype)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, scale_factor: float = 2.0,
                 scale_heads: bool = True):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scaling = float(self.head_dim * scale_factor) ** -0.5
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)
        self.c_attn = nn.Parameter(torch.ones(num_heads)) if scale_heads else None

    def forward(self, query, key=None, bias=None, key_padding_mask=None,
                causal: bool = False, prompt_kv=None):
        """query (B, Lq, D); key (B, Lk, D) or None for self-attention; bias
        (H, Lq, Lk); key_padding_mask (B, Lk) bool, True = pad."""
        if prompt_kv is not None:
            raise NotImplementedError("prefix-tuning prompt_kv is not ported")
        if key is None:
            key = query
        q = self.q_proj(query) * self.scaling
        k = self.k_proj(key)
        v = self.v_proj(key)
        b, lq, _ = q.shape
        if k.shape[0] != b:
            raise NotImplementedError("grouped cross-attention is not ported")
        if bias is not None and bias.dim() != 3:
            raise NotImplementedError("only a batch-shared (H, Lq, Lk) bias is ported")
        out = flash_attention_bias_packed_infer(
            q, k, v, bias, key_padding_mask, causal, self.num_heads
        )
        if self.c_attn is not None:
            out = out.view(b, lq, self.num_heads, self.head_dim)
            out = (out * self.c_attn.to(out.dtype)[:, None]).reshape(b, lq, self.embed_dim)
        return self.out_proj(out)
