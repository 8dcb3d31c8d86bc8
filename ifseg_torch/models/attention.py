"""Multi-head attention with additive position bias and per-head gains.

The math of models/segofa/unify_multihead_attention.py, as the JAX package's
``models/attention.py`` computes it:
  - q scaled by (head_dim * scale_factor) ** -0.5 on the projection output,
    in compute dtype;
  - an additive bias, (H, Lq, Lk) shared across the batch or (B, H, Lq, Lk);
  - a key-padding mask and causal masking with the offset lk - lq;
  - an optional per-head gain ``c_attn`` ("scale_heads");
  - prefix tuning (``prompt_kv``, unify_multihead_attention.py:453-459): P
    learned key/value rows prepended to every row of the batch; the bias
    gets P zero columns in front (the reference adds it to the trailing
    real keys), the key mask P unmasked columns, and the causal offset
    lk - lq keeps the whole prefix visible to every query;
  - grouped cross-attention (:159-274): a query batch of G·Bk rows over a
    key batch of Bk, K/V shared by the G rows of a group (beam search).

Batch-major (B, L, D).  The attention itself is ``ops.flash_attention``: with
gradients enabled ``flash_attention_bias_packed_stats`` (forward with the row
logsumexp, backward by the two backward kernels), otherwise
``flash_attention_bias_packed_infer`` — the Hopper kernels for CUDA tensors,
their plain versions for CPU tensors.  The plain softmax attention below
(``plain_attention``) takes what the JAX package computes outside its
Pallas kernel, on whatever device the tensors are: attention dropout > 0 in
training, a (B, H, Lq, Lk) bias, grouped cross-attention, and every site of
a model built with ``use_flash_attention=False``.

Under ``--context-parallel`` (a self-attention built with ``plan``) the
site rings (``parallel/context.py:ring_attention``) where the JAX package's
does: more than one rank on the ring, as many queries as keys (no prefix),
no attention dropout in training, and no 4-D bias.  The ring is fp32
einsums with an online softmax, as in the JAX package; the other sites keep
the kernels.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ifseg_torch.ops.flash_attention import (
    NEG_INF,
    empty_row_padded,
    flash_attention_bias_packed_infer,
    flash_attention_bias_packed_stats,
)
from ifseg_torch.parallel.context import ring_attention


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


def prefixed_pack(shape, p: int, dtype, device):
    """(pack, body): uninitialised row-padded storage
    (``ops.flash_attention.empty_row_padded``) of ``shape`` (..., Lq, Lk)
    widened to P + Lk keys, its first P columns zero, and the view of its
    last Lk columns for the caller to fill.  The kernels fetch every bias
    of such a pack by TMA whatever P + Lk is; filled in the graph, the
    gradient of the body flows back to what was written there, and that of
    the zero columns is dropped, as the JAX package's ``jnp.pad`` drops it."""
    pack = empty_row_padded((*shape[:-1], p + shape[-1]), dtype, device)
    if p:
        pack[..., :p].zero_()
    return pack, pack[..., p:]


def prefix_bias(bias: torch.Tensor, p: int) -> torch.Tensor:
    """``bias`` (..., Lq, Lk) with P zero columns in front, (..., Lq, P + Lk),
    in a ``prefixed_pack``."""
    pack, body = prefixed_pack(bias.shape, p, bias.dtype, bias.device)
    body.copy_(bias)
    return pack


def plain_attention(q, k, v, bias, key_padding_mask, causal: bool, num_heads: int,
                    dropout=None):
    """Softmax attention in the packed layout, the JAX package's XLA path:
    fp32 logits, the bias ((H, Lq, Lk), or (B, H, Lq, Lk) whose rows are
    q's), causal and key masks to -1e9, probabilities in q's dtype (then
    ``dropout``), their product with v.  Grouped when k has Bk < B rows: the
    G = B / Bk query rows of a group share one row of K/V (and of the key
    mask), and a (B, H, Lq, Lk) bias is read beam-major."""
    b, lq, e = q.shape
    bk, lk = k.shape[:2]
    g = b // bk
    if bk * g != b:
        raise ValueError(f"query batch {b} is not a multiple of key batch {bk}")
    hd = e // num_heads
    qg = q.reshape(bk, g, lq, num_heads, hd).float()
    logits = torch.einsum("bgqhd,bkhd->bghqk", qg, k.reshape(bk, lk, num_heads, hd).float())
    if bias is not None:
        logits = logits + (bias.float() if bias.dim() == 3
                           else bias.reshape(bk, g, num_heads, lq, lk).float())
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout is not None:
        probs = dropout(probs)
    out = torch.einsum("bghqk,bkhd->bgqhd", probs, v.reshape(bk, lk, num_heads, hd))
    return out.reshape(b, lq, e)


class MultiheadAttention(nn.Module):
    # tensor parallelism (parallel/tensor.py): num_heads is then this rank's
    # share of the heads and c_attn is used by its slice
    tp = None

    def __init__(self, embed_dim: int, num_heads: int, scale_factor: float = 2.0,
                 scale_heads: bool = True, dropout: float = 0.0, use_flash: bool = True,
                 plan=None):
        super().__init__()
        self.plan = plan
        self.dropout = Dropout(dropout)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scaling = float(self.head_dim * scale_factor) ** -0.5
        self.use_flash = use_flash
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)
        self.c_attn = nn.Parameter(torch.ones(num_heads)) if scale_heads else None

    def forward(self, query, key=None, bias=None, key_padding_mask=None,
                causal: bool = False, prompt_kv=None):
        """query (B, Lq, D); key (Bk, Lk, D) — B = G·Bk groups the queries —
        or None for self-attention; bias (H, Lq, Lk) or (B, H, Lq, Lk), or,
        with ``prompt_kv``, already (..., Lq, P + Lk) with the P zero columns
        in front (``prefix_bias``); key_padding_mask (Bk, Lk) bool, True =
        pad; prompt_kv (2, H, P, head_dim), self-attention only."""
        if key is None:
            key = query
        q = self.q_proj(query) * self.scaling
        k = self.k_proj(key)
        v = self.v_proj(key)
        b, lq, _ = q.shape
        if prompt_kv is not None:
            k, v, bias, key_padding_mask = self._prepend(prompt_kv, k, v, bias, key_padding_mask)
        packed = (q, k, v, bias, key_padding_mask, causal, self.num_heads)
        dropping = self.training and self.dropout.rate > 0.0
        if (self.plan is not None and self.plan.context_parallel > 1 and not dropping
                and q.shape[1] == k.shape[1] and k.shape[0] == b
                and (bias is None or bias.dim() == 3)):
            out = ring_attention(*packed, group=self.plan.group)
        elif (not self.use_flash or dropping or k.shape[0] != b
                or (bias is not None and bias.dim() != 3)):
            out = plain_attention(*packed, dropout=self.dropout if dropping else None)
        elif torch.is_grad_enabled():
            out, _lse = flash_attention_bias_packed_stats(*packed)
        else:
            out = flash_attention_bias_packed_infer(*packed)
        if self.c_attn is not None:
            c_attn = self.c_attn if self.tp is None else self.tp.part(self.c_attn, 0)
            out = out.view(b, lq, self.num_heads, self.head_dim)
            out = (out * c_attn.to(out.dtype)[:, None]).reshape(b, lq, -1)
        return self.out_proj(out)

    def _prepend(self, prompt_kv, k, v, bias, key_padding_mask):
        """K/V with the P prompt rows in front of every batch row (one
        contiguous packed tensor each, as the kernels take them), the bias and
        key mask widened to match."""
        b, lk, e = k.shape
        p = prompt_kv.shape[2]
        if b * lk == 0 or prompt_kv.shape[1] * prompt_kv.shape[3] != e:
            raise ValueError(f"prompt_kv {tuple(prompt_kv.shape)} does not fit keys {tuple(k.shape)}")
        rows = prompt_kv.transpose(1, 2).reshape(2, 1, p, e)  # (2, 1, P, H*dh)
        k = torch.cat([rows[0].to(k.dtype).expand(b, p, e), k], dim=1)
        v = torch.cat([rows[1].to(v.dtype).expand(b, p, e), v], dim=1)
        if bias is not None and bias.shape[-1] == lk:
            bias = prefix_bias(bias, p)
        elif bias is not None and bias.shape[-1] != p + lk:
            raise ValueError(f"bias of {bias.shape[-1]} keys for {lk} keys and a prefix of {p}")
        if key_padding_mask is not None:
            key_padding_mask = torch.cat(
                [key_padding_mask.new_zeros(b, p), key_padding_mask], dim=1)
        return k, v, bias, key_padding_mask
