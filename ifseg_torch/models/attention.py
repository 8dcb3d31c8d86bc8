"""Multi-head attention with additive position bias and per-head gains.

The math of models/segofa/unify_multihead_attention.py, as the JAX package's
``models/attention.py`` computes it:
  - q scaled by (head_dim * scale_factor) ** -0.5 on the projection output,
    in compute dtype;
  - an additive (H, Lq, Lk) bias shared across the batch;
  - a key-padding mask and causal masking with the offset lk - lq;
  - an optional per-head gain ``c_attn`` ("scale_heads").

Batch-major (B, L, D).  The attention itself is ``ops.flash_attention``: with
gradients enabled ``flash_attention_bias_packed_stats`` (forward with the row
logsumexp, backward by the two backward kernels), otherwise
``flash_attention_bias_packed_infer`` — the Hopper kernels for CUDA tensors,
their plain versions for CPU tensors.  Attention dropout > 0 in training
takes the plain softmax path with dropout on the probabilities, as the JAX
package does.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ifseg_torch.ops.flash_attention import (
    _masked_logits,
    flash_attention_bias_packed_infer,
    flash_attention_bias_packed_stats,
)


class Dropout(nn.Module):
    """Inverted dropout drawing its mask from an explicit ``torch.Generator``
    on the input's device (``self.generator``, set by ``set_generator``), so
    a run repeats bit-for-bit from the generator's seed.  Identity in eval
    mode or at rate 0; holds no parameters."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return x * mask.to(x.dtype) / keep


def set_generator(module: nn.Module, generator) -> None:
    """Point every stochastic submodule of ``module`` at ``generator``."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator


class Linear(nn.Linear):
    """``nn.Linear`` computing in the input's dtype: fp32 params are cast at
    use, as flax's ``Dense(dtype=...)`` does (a no-op once a server has cast
    the weights to compute dtype)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, scale_factor: float = 2.0,
                 scale_heads: bool = True, dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
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
        packed = (q, k, v, bias, key_padding_mask, causal, self.num_heads)
        if self.training and self.dropout.rate > 0.0:
            out = self._softmax_dropout(*packed)
        elif torch.is_grad_enabled():
            out, _lse = flash_attention_bias_packed_stats(*packed)
        else:
            out = flash_attention_bias_packed_infer(*packed)
        if self.c_attn is not None:
            out = out.view(b, lq, self.num_heads, self.head_dim)
            out = (out * self.c_attn.to(out.dtype)[:, None]).reshape(b, lq, self.embed_dim)
        return self.out_proj(out)

    def _softmax_dropout(self, q, k, v, bias, key_padding_mask, causal, num_heads):
        """Plain softmax attention with dropout on the probabilities."""
        b, lq, _ = q.shape
        lk = k.shape[1]
        logits = _masked_logits(q, k, bias, key_padding_mask, causal, num_heads)
        probs = self.dropout(torch.softmax(logits, dim=-1).to(q.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.view(b, lk, num_heads, self.head_dim))
        return out.reshape(b, lq, self.embed_dim)
