"""Context parallelism: ring attention over the model axis.

The JAX package's ``parallel/context.py``: the sequence is cut into n
chunks over the n ranks of the ring; each rank keeps its chunk of query
rows and passes the key/value chunks around the ring (``comm.ppermute``,
K and V stacked into one buffer a step), accumulating an online softmax in
fp32 (running max, sum and output), so no rank holds the whole (Lq, Lk)
logits.  Exact: the same attention as the dense one, to float rounding.

Layout: the packed (B, L, H·D) projections of ``models/attention.py``.  A
length that does not divide n is zero-padded to n·⌈L/n⌉ (padded keys
masked, padded rows sliced off).  The bias (H, L, L) keeps the rank's
query rows and is sliced by the resident chunk's key columns each step;
the key padding mask is sliced, never passed around; a causal mask
compares global rows and columns.  The logits are fp32 einsums of the
inputs cast to fp32, masked to -1e9 as the JAX package masks them.

Every rank computes the q/k/v projections of all rows (the batch rows of
its data shard), so the slices enter through ``comm.slice_to`` (the
backward gathers the gradient rows whole on every rank) and the output
leaves through ``comm.gather_from`` (the backward keeps the rank's rows):
the projections' gradients, and the bias's, are whole on every rank, as
is every other gradient of the model, and nothing is summed across the
ring afterwards.  The running max is a constant of the backward (its
gradient contributions cancel).
"""

import torch
import torch.nn.functional as F

from .comm import gather_from, group_rank, group_size, ppermute, slice_to

NEG_INF = -1e9


def ring_attention(q, k, v, bias, key_padding_mask, causal: bool, num_heads: int, group):
    """Softmax attention of q (B, L, H·D), already scaled, over k, v (B, L,
    H·D) with ``bias`` (H, L, L) or None, ``key_padding_mask`` (B, L) bool
    (True = pad) or None and causal masking, the sequence split over the
    ranks of ``group``; returns (B, L, H·D) in q's dtype on every rank."""
    n, idx = group_size(group), group_rank(group)
    b, l, e = q.shape
    hd = e // num_heads
    lp = -(-l // n) * n
    if lp != l:
        pad = lp - l
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        if key_padding_mask is None:
            key_padding_mask = torch.zeros(b, l, dtype=torch.bool, device=q.device)
        key_padding_mask = F.pad(key_padding_mask, (0, pad), value=True)
        if bias is not None:  # padded rows are sliced off, padded columns masked
            bias = F.pad(bias, (0, pad, 0, pad))
    lc = lp // n
    q_l = slice_to(q, 1, group).float().reshape(b, lc, num_heads, hd)
    kv = slice_to(torch.stack([k, v]), 2, group)  # (2, B, Lc, H·D): one buffer a step
    bias_l = None if bias is None else slice_to(bias, 1, group)  # (H, Lc, Lp)
    rows = idx * lc + torch.arange(lc, device=q.device)
    o = m = s = None
    perm = [(i, (i + 1) % n) for i in range(n)]
    for t in range(n):
        col = ((idx - t) % n) * lc  # the resident chunk's first key
        kf = kv[0].float().reshape(b, lc, num_heads, hd)
        vf = kv[1].float().reshape(b, lc, num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q_l, kf)
        if bias_l is not None:
            logits = logits + bias_l[:, :, col:col + lc].float()
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, col:col + lc], NEG_INF)
        if causal:
            cols = col + torch.arange(lc, device=q.device)
            logits = logits.masked_fill(cols[None, :] > rows[:, None], NEG_INF)
        m_new = logits.detach().amax(dim=-1, keepdim=True)
        if m is not None:
            m_new = torch.maximum(m, m_new)
        p = torch.exp(logits - m_new)
        pv = torch.einsum("bhqk,bkhd->bhqd", p, vf)
        if o is None:
            o, s = pv, p.sum(-1, keepdim=True)
        else:
            scale = torch.exp(m - m_new)
            o, s = o * scale + pv, s * scale + p.sum(-1, keepdim=True)
        m = m_new
        if t < n - 1:
            kv = ppermute(kv, perm, group)
    out = (o / s.clamp(min=1e-30)).to(q.dtype)  # (B, H, Lc, D)
    out = gather_from(out.permute(0, 2, 1, 3).reshape(b, lc, e), 1, group)
    return out[:, :l] if lp != l else out
