"""Fused attention with an additive per-head bias (packed layout).

``flash_attention_bias_packed_infer`` is the port of the JAX package's
inference entry point of the same name: q (B, Lq, H·D), k/v (B, Lk, H·D) —
the raw projection outputs — a bias (H, Lq, Lk) shared across the batch, an
optional key-padding mask (B, Lk) (True = pad) and causal masking with the
offset lk - lq.  Output (B, Lq, H·D) in q's dtype.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/flash_attention_bias_fwd.cu`` (or raises); on a CPU tensor it runs the
plain version ``attention_bias_reference``, which is also what the kernel is
held against on the card.
"""

import ctypes
from typing import Optional

import torch

from ifseg_torch.ops import build

NEG_INF = -1e9
KERNEL = "flash_attention_bias_fwd"
HEAD_DIM = 64  # the kernel's head dim (OFA-Base and every larger SegOFA)

# kernel launches since the count was last set to 0 (chip_smoke.py reads it)
LAUNCHES = 0


def attention_bias_reference(q, k, v, bias, key_padding_mask, causal, num_heads):
    """Plain version: einsum/softmax in fp32 in the packed layout, the
    arithmetic of the JAX package's ``_attention_xla``."""
    b, lq, e = q.shape
    lk = k.shape[1]
    d = e // num_heads
    qh = q.reshape(b, lq, num_heads, d).float()
    kh = k.reshape(b, lk, num_heads, d).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if bias is not None:
        logits = logits + bias[None].float()
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.reshape(b, lk, num_heads, d))
    return out.reshape(b, lq, e).to(q.dtype)


def _check(q, k, v, bias, key_padding_mask, causal, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be packed (B, L, H*D)")
    b, lq, e = q.shape
    lk = k.shape[1]
    if e != num_heads * HEAD_DIM:
        raise ValueError(f"kernel supports head dim {HEAD_DIM}; got {e}/{num_heads}")
    if tuple(k.shape) != (b, lk, e) or tuple(v.shape) != (b, lk, e):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if lq < 1 or lk < 1:
        raise ValueError("empty sequence")
    if causal and lk < lq:
        raise ValueError("causal with Lk < Lq leaves fully masked rows; not supported")
    if -(-lq // 64) > 65535 or num_heads > 65535:
        raise ValueError("grid too large")
    tensors = [("q", q), ("k", k), ("v", v)]
    for name, x in tensors:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
    if bias is not None:
        if bias.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"bias must be bfloat16 or float32, got {bias.dtype}")
        if tuple(bias.shape) != (num_heads, lq, lk):
            raise ValueError(f"bias shape {tuple(bias.shape)} != {(num_heads, lq, lk)}")
        tensors.append(("bias", bias))
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool or tuple(key_padding_mask.shape) != (b, lk):
            raise ValueError("key_padding_mask must be bool (B, Lk)")
        tensors.append(("key_padding_mask", key_padding_mask))
    for name, x in tensors:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in tensors[:3]:
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q, k, v, bias, key_padding_mask, causal, num_heads):
    global LAUNCHES
    _check(q, k, v, bias, key_padding_mask, causal, num_heads)
    lib = build.load(KERNEL)
    fn = lib.flash_attention_bias_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, lq, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == torch.float32),
            None if key_padding_mask is None else key_padding_mask.data_ptr(),
            out.data_ptr(), b, num_heads, lq, k.shape[1], int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def flash_attention_bias_packed_infer(q, k, v, bias: Optional[torch.Tensor],
                                      key_padding_mask: Optional[torch.Tensor],
                                      causal: bool, num_heads: int):
    """Inference-only packed fused attention (no row logsumexp output)."""
    if q.device.type == "cpu":
        return attention_bias_reference(q, k, v, bias, key_padding_mask, causal, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, bias, key_padding_mask, causal, num_heads)
