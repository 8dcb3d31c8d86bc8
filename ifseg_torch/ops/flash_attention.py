"""Fused attention with an additive per-head bias (packed layout).

The port of the JAX package's packed entry points, with their names:

``flash_attention_bias_packed_infer``   output only, no gradient (serving);
``flash_attention_bias_packed_stats``   (out, lse), differentiable in q, k, v
                                        and bias (training);
``flash_attention_bias_packed``         output only, differentiable.

q (B, Lq, H·D), k/v (B, Lk, H·D) — the raw projection outputs — a bias
(H, Lq, Lk) shared across the batch (dense, or a view of row-padded storage
as ``row_padded`` makes it), an optional key-padding mask (B, Lk)
(True = pad) and causal masking with the offset lk - lq.  Output (B, Lq, H·D)
in q's dtype; lse, the row logsumexp of the masked logits, (B, H, Lq) fp32.

On CUDA tensors these launch the hand-written Hopper kernels (or raise), all
on wgmma and TMA: ``csrc/flash_attention_bias_fwd.cu`` for the forward, with
or without the lse output (a bias whose rows are 16-byte aligned is fetched by
TMA, any other is staged by threads, more slowly), and for the gradient
``csrc/flash_attention_bias_bwd_dq.cu`` (the di pre-pass, then dq and dbias)
and ``csrc/flash_attention_bias_bwd_dkv.cu`` (dk and dv), which rebuild the
probabilities from the saved lse and take the bias by TMA only: the backward
row-pads a bias whose rows are not 16-byte aligned (a copy, counted in
``BWD_BIAS_COPIES``; the models build their packs row-padded, so none is
made on their paths).  On CPU tensors
they run the plain versions below — ``attention_bias_reference``,
``attention_bias_stats_reference`` and the explicit
``attention_bias_backward_reference`` (not autograd of the forward) — which
are also what the kernels are held against on the card.
"""

import ctypes
from typing import Dict, Optional

import torch

from ifseg_torch.ops import build

NEG_INF = -1e9
KERNEL = "flash_attention_bias_fwd"
KERNEL_BWD_DQ = "flash_attention_bias_bwd_dq"
KERNEL_BWD_DKV = "flash_attention_bias_bwd_dkv"
KERNELS = (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)  # one source file each
HEAD_DIM = 64  # the kernels' head dim (OFA-Base and every larger SegOFA)
# the dq + dbias kernel's query rows per CTA and keys per stage: its fp32
# dbias workspace is padded to them
DQ_TILE_Q, DQ_TILE_K = 128, 64

# kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the forward without stats, the forward with stats, the di pre-pass,
# the dq + dbias kernel and the dk + dv kernel
LAUNCHES = 0
LAUNCHES_STATS = 0
LAUNCHES_BWD_DI = 0
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKV = 0
# forward launches (with or without stats) by the route their bias took: TMA
# (rows 16-byte aligned) or the producer's threads; and the bias copies the
# backward made to row-pad a bias whose rows TMA cannot take
LAUNCHES_BIAS_TMA = 0
LAUNCHES_BIAS_THREADS = 0
BWD_BIAS_COPIES = 0


def reset_launches():
    global LAUNCHES, LAUNCHES_STATS, LAUNCHES_BWD_DI, LAUNCHES_BWD_DQ, LAUNCHES_BWD_DKV
    global LAUNCHES_BIAS_TMA, LAUNCHES_BIAS_THREADS, BWD_BIAS_COPIES
    LAUNCHES = LAUNCHES_STATS = LAUNCHES_BWD_DI = LAUNCHES_BWD_DQ = LAUNCHES_BWD_DKV = 0
    LAUNCHES_BIAS_TMA = LAUNCHES_BIAS_THREADS = BWD_BIAS_COPIES = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launches``, by kernel."""
    return dict(infer=LAUNCHES, stats=LAUNCHES_STATS, bwd_di=LAUNCHES_BWD_DI,
                bwd_dq=LAUNCHES_BWD_DQ, bwd_dkv=LAUNCHES_BWD_DKV)


def bias_route_counts() -> Dict[str, int]:
    """Forward launches by bias route, and the backward's bias copies."""
    return dict(fwd_bias_tma=LAUNCHES_BIAS_TMA, fwd_bias_threads=LAUNCHES_BIAS_THREADS,
                bwd_bias_copies=BWD_BIAS_COPIES)


# ------------------------------------------------------------ plain versions

def _heads(x, num_heads):
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads)


def _masked_logits(q, k, bias, key_padding_mask, causal, num_heads):
    """(B, H, Lq, Lk) fp32 logits with bias, causal and padding masks applied."""
    lq, lk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", _heads(q, num_heads).float(),
                          _heads(k, num_heads).float())
    if bias is not None:
        logits = logits + bias[None].float()
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    return logits


def attention_bias_reference(q, k, v, bias, key_padding_mask, causal, num_heads):
    """Plain version: einsum/softmax in fp32 in the packed layout, the
    arithmetic of the JAX package's ``_attention_xla``."""
    logits = _masked_logits(q, k, bias, key_padding_mask, causal, num_heads)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _heads(v, num_heads))
    return out.reshape(q.shape).to(q.dtype)


def attention_bias_stats_reference(q, k, v, bias, key_padding_mask, causal, num_heads):
    """Plain version of the forward with stats: (out, lse), lse (B, H, Lq)
    fp32 the row logsumexp of the masked logits."""
    logits = _masked_logits(q, k, bias, key_padding_mask, causal, num_heads)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _heads(v, num_heads))
    return out.reshape(q.shape).to(q.dtype), lse


def _backward_terms(q, k, v, bias, key_padding_mask, causal, g, out, lse, num_heads):
    """(p, ds) of the backward, (B, H, Lq, Lk) fp32: p = exp(logits − lse) and
    ds = p ∘ (g·vᵀ − di), from the saved (out, lse)."""
    logits = _masked_logits(q, k, bias, key_padding_mask, causal, num_heads)
    p = torch.exp(logits - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", _heads(g, num_heads).float(),
                      _heads(v, num_heads).float())
    return p, p * (dp - attention_di_reference(g, out, num_heads)[..., None])


def attention_bias_dq_dbias_reference(q, k, v, bias, key_padding_mask, causal, g, out, lse,
                                      num_heads):
    """Plain version of the dq + dbias kernel: dq = ds·k and dbias = Σ_b ds
    (fp32 sum, rounded once to the bias dtype; None without a bias)."""
    _, ds32 = _backward_terms(q, k, v, bias, key_padding_mask, causal, g, out, lse, num_heads)
    ds = ds32.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _heads(k, num_heads).float())
    dbias = None if bias is None else ds32.sum(0).to(bias.dtype)
    return dq.reshape(q.shape).to(q.dtype), dbias


def attention_bias_dkv_reference(q, k, v, bias, key_padding_mask, causal, g, out, lse,
                                 num_heads):
    """Plain version of the dk + dv kernel: dk = dsᵀ·q and dv = pᵀ·g."""
    p32, ds32 = _backward_terms(q, k, v, bias, key_padding_mask, causal, g, out, lse, num_heads)
    p, ds = p32.to(q.dtype).float(), ds32.to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _heads(q, num_heads).float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, _heads(g, num_heads).float())
    return dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype)


def attention_bias_backward_reference(q, k, v, bias, key_padding_mask, causal, g, out, lse,
                                      num_heads):
    """Plain version of the backward, the five products of the JAX package's
    ``_xla_stats_backward`` from the saved (out, lse):

        p = exp(logits − lse),  di = rowsum(g ∘ out),  dp = g·vᵀ,
        ds = p ∘ (dp − di),  dq = ds·k,  dk = dsᵀ·q,  dv = pᵀ·g,
        dbias = Σ_b ds  (fp32 sum, rounded once to the bias dtype).

    p and ds are rounded to the compute dtype before the last three products,
    as the kernels round them.  Returns (dq, dk, dv, dbias or None)."""
    args = (q, k, v, bias, key_padding_mask, causal, g, out, lse, num_heads)
    dq, dbias = attention_bias_dq_dbias_reference(*args)
    dk, dv = attention_bias_dkv_reference(*args)
    return dq, dk, dv, dbias


def attention_di_reference(g, out, num_heads):
    """di = rowsum(g ∘ out) per head, (B, H, Lq) fp32."""
    return (_heads(g, num_heads).float() * _heads(out, num_heads).float()).sum(-1).transpose(1, 2)


# ------------------------------------------------------------------ launches

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
    # the grids' y and z: tiles of 128 query rows or keys (a bound of 64 keeps a margin), heads
    if -(-lq // 64) > 65535 or -(-lk // 64) > 65535 or num_heads > 65535:
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
        if not (x.is_contiguous() or (x is bias and _is_row_padded(bias))):
            raise ValueError(f"{name} must be contiguous" + (
                " or a [..., :Lk] view of contiguous row-padded storage" if x is bias else ""))
    for name, x in tensors[:3]:  # what TMA always reads
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _is_row_padded(bias) -> bool:
    """A (H, Lq, Lk) view whose rows are ``pitch`` >= Lk elements apart, the
    heads Lq such rows apart: what ``row_padded`` makes."""
    _, lq, lk = bias.shape
    pitch = bias.stride(1)
    return bias.stride(2) == 1 and pitch >= lk and bias.stride(0) == lq * pitch


def tma_rows(bias) -> bool:
    """Whether TMA can fetch the bias: (H, Lq, Lk) dense or row-padded, its
    rows and its start on 16-byte boundaries."""
    return ((bias.is_contiguous() or _is_row_padded(bias))
            and (bias.stride(1) * bias.element_size()) % 16 == 0 and bias.data_ptr() % 16 == 0)


def empty_row_padded(shape, dtype, device) -> torch.Tensor:
    """An uninitialised tensor of ``shape`` (..., Lk) whose rows are a
    multiple of 8 elements apart: the [..., :Lk] view of wider storage."""
    lk = shape[-1]
    return torch.empty(*shape[:-1], -(-lk // 8) * 8, dtype=dtype, device=device)[..., :lk]


def row_padded(bias: torch.Tensor) -> torch.Tensor:
    """``bias`` (..., Lk) in storage whose rows are a multiple of 8 elements
    apart, as the [..., :Lk] view of it: rows of bf16 (or fp32) then start at
    multiples of 16 bytes whatever Lk is, which is what lets the kernels fetch
    the bias by TMA.  Same values, same shape; the padding is left
    unwritten (nothing reads it).  A copy in the graph: autograd carries a
    gradient back through it.  A (H, Lq, Lk) bias that TMA can already take
    is returned as it is."""
    if bias.dim() == 3 and tma_rows(bias):
        return bias
    return empty_row_padded(bias.shape, bias.dtype, bias.device).copy_(bias)


def _check_backward(q, g, out, lse, num_heads):
    b, lq, _ = q.shape
    for name, x in (("g", g), ("out", out)):
        if x.dtype != torch.bfloat16 or tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} must be bfloat16 {tuple(q.shape)}, got {x.dtype} {tuple(x.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, num_heads, lq):
        raise ValueError(f"lse must be float32 {(b, num_heads, lq)}")
    if num_heads > 32:
        raise ValueError("the di pre-pass takes at most 32 heads")
    for name, x in (("g", g), ("out", out), ("lse", lse)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")


def _ptr(x):
    return None if x is None else x.data_ptr()


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "flash_attention_bias_fwd": [_P] * 4 + [_I] * 2 + [_P] * 2 + [_I] * 5 + [_P],
    "flash_attention_bias_fwd_stats": [_P] * 4 + [_I] * 2 + [_P] * 3 + [_I] * 5 + [_P],
    "flash_attention_bias_fwd_encode_us": [_P] * 4 + [_I] * 7,
    "flash_attention_bias_fwd_smem_bytes": [_I],
    "flash_attention_bwd_di": [_P] * 3 + [_I] * 3 + [_P],
    "flash_attention_bias_bwd_dq": [_P] * 4 + [_I] * 2 + [_P] * 6 + [_I] * 5 + [_P],
    "flash_attention_bias_bwd_dkv": [_P] * 4 + [_I] * 2 + [_P] * 6 + [_I] * 5 + [_P],
    "flash_attention_bias_bwd_dq_smem_bytes": [_I],
    "flash_attention_bias_bwd_dkv_smem_bytes": [_I],
}


def _call(kernel: str, entry: str, device, *args):
    """Call C entry ``entry`` of ``kernel``'s library on ``device``'s current
    stream (appended as the last argument); raise unless it launched."""
    fn = getattr(build.load(kernel), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")


def _bias_args(bias, lk):
    """(pointer, is fp32, row pitch in elements) of the bias for the C entries."""
    if bias is None:
        return None, 0, lk
    return bias.data_ptr(), int(bias.dtype == torch.float32), bias.stride(1)


def _launch(q, k, v, bias, key_padding_mask, causal, num_heads, with_stats=False):
    global LAUNCHES, LAUNCHES_STATS, LAUNCHES_BIAS_TMA, LAUNCHES_BIAS_THREADS
    _check(q, k, v, bias, key_padding_mask, causal, num_heads)
    b, lq, _ = q.shape
    out = torch.empty_like(q)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *_bias_args(bias, k.shape[1]),
            _ptr(key_padding_mask), out.data_ptr())
    dims = (b, num_heads, lq, k.shape[1], int(bool(causal)))
    if bias is not None:  # the kernel's own rule (encode_maps) for fetching the bias by TMA
        if tma_rows(bias):
            LAUNCHES_BIAS_TMA += 1
        else:
            LAUNCHES_BIAS_THREADS += 1
    if not with_stats:
        _call(KERNEL, "flash_attention_bias_fwd", q.device, *head, *dims)
        LAUNCHES += 1
        return out
    lse = torch.empty(b, num_heads, lq, dtype=torch.float32, device=q.device)
    _call(KERNEL, "flash_attention_bias_fwd_stats", q.device, *head, lse.data_ptr(), *dims)
    LAUNCHES_STATS += 1
    return out, lse


def tensor_map_encode_us(q, k, v, bias, num_heads, iters=200) -> float:
    """Host microseconds one forward launch spends encoding its TMA tensor
    maps (q, k, v, and the bias where its rows are 16-byte aligned), the mean
    of ``iters`` repetitions.  Launches nothing."""
    fn = build.load(KERNEL).flash_attention_bias_fwd_encode_us
    fn.argtypes = _ARGTYPES["flash_attention_bias_fwd_encode_us"]
    fn.restype = ctypes.c_double
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_bias_args(bias, k.shape[1]),
            q.shape[0], num_heads, q.shape[1], k.shape[1], iters)
    if us < 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused a tensor map")
    return us


def smem_bytes(kernel: str, bias_fp32: bool) -> int:
    """Dynamic shared memory one CTA of ``kernel`` (one of ``KERNELS``)
    takes, in bytes, with an fp32 or a bf16 bias."""
    entry = f"{kernel}_smem_bytes"
    fn = getattr(build.load(kernel), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn(int(bias_fp32))


def _launch_di(g, out, num_heads):
    global LAUNCHES_BWD_DI
    b, lq, _ = g.shape
    di = torch.empty(b, num_heads, lq, dtype=torch.float32, device=g.device)
    _call(KERNEL_BWD_DQ, "flash_attention_bwd_di", g.device,
          g.data_ptr(), out.data_ptr(), di.data_ptr(), b, num_heads, lq)
    LAUNCHES_BWD_DI += 1
    return di


def _backward_args(q, k, v, bias, key_padding_mask, causal, g, lse, di, num_heads):
    if bias is not None and not tma_rows(bias):
        raise ValueError("the backward kernels take a bias whose rows are 16-byte aligned "
                         "(row_padded makes them so)")
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *_bias_args(bias, k.shape[1]),
            _ptr(key_padding_mask), g.data_ptr(), lse.data_ptr(), di.data_ptr())
    return head, (q.shape[0], num_heads, q.shape[1], k.shape[1], int(bool(causal)))


def _launch_dq(q, k, v, bias, key_padding_mask, causal, g, lse, di, num_heads, need_dbias=True):
    """(dq, dbias or None) by the dq + dbias kernel; the caller has checked
    the operands.  dbias is dense (H, Lq, Lk) in the bias dtype."""
    global LAUNCHES_BWD_DQ
    lq, lk = q.shape[1], k.shape[1]
    head, dims = _backward_args(q, k, v, bias, key_padding_mask, causal, g, lse, di, num_heads)
    dq = torch.empty_like(q)
    ws = None
    if bias is not None and need_dbias:  # fp32 sum over the batch, padded to the tiles
        ws = torch.zeros(num_heads, -(-lq // DQ_TILE_Q) * DQ_TILE_Q,
                         -(-lk // DQ_TILE_K) * DQ_TILE_K, dtype=torch.float32, device=q.device)
    _call(KERNEL_BWD_DQ, "flash_attention_bias_bwd_dq", q.device,
          *head, dq.data_ptr(), _ptr(ws), *dims)
    LAUNCHES_BWD_DQ += 1
    if ws is None:
        return dq, None
    return dq, ws[:, :lq, :lk].to(bias.dtype).contiguous()  # rounded once to the bias dtype


def _launch_dkv(q, k, v, bias, key_padding_mask, causal, g, lse, di, num_heads):
    """(dk, dv) by the dk + dv kernel; the caller has checked the operands."""
    global LAUNCHES_BWD_DKV
    head, dims = _backward_args(q, k, v, bias, key_padding_mask, causal, g, lse, di, num_heads)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(KERNEL_BWD_DKV, "flash_attention_bias_bwd_dkv", q.device,
          *head, dk.data_ptr(), dv.data_ptr(), *dims)
    LAUNCHES_BWD_DKV += 1
    return dk, dv


def _launch_backward(q, k, v, bias, key_padding_mask, causal, g, out, lse, num_heads,
                     need_dbias=True):
    """(dq, dk, dv, dbias or None) by the backward kernels."""
    global BWD_BIAS_COPIES
    _check(q, k, v, bias, key_padding_mask, causal, num_heads)
    _check_backward(q, g, out, lse, num_heads)
    if bias is not None:
        taken = row_padded(bias)  # the kernels fetch the bias by TMA only
        BWD_BIAS_COPIES += int(taken is not bias)
        bias = taken
    di = _launch_di(g, out, num_heads)
    args = (q, k, v, bias, key_padding_mask, causal, g, lse, di, num_heads)
    dq, dbias = _launch_dq(*args, need_dbias=need_dbias)
    dk, dv = _launch_dkv(*args)
    return dq, dk, dv, dbias


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


# --------------------------------------------------------------- entry points

def flash_attention_bias_packed_infer(q, k, v, bias: Optional[torch.Tensor],
                                      key_padding_mask: Optional[torch.Tensor],
                                      causal: bool, num_heads: int):
    """Inference-only packed fused attention (no row logsumexp output)."""
    if _device_kind(q) == "cpu":
        return attention_bias_reference(q, k, v, bias, key_padding_mask, causal, num_heads)
    return _launch(q, k, v, bias, key_padding_mask, causal, num_heads)


class _PackedStats(torch.autograd.Function):
    """Forward with stats; backward from the saved (out, lse) by the two
    backward kernels (CUDA) or the plain explicit backward (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_padding_mask, causal, num_heads):
        if _device_kind(q) == "cpu":
            out, lse = attention_bias_stats_reference(
                q, k, v, bias, key_padding_mask, causal, num_heads)
        else:
            out, lse = _launch(q, k, v, bias, key_padding_mask, causal, num_heads,
                               with_stats=True)
        ctx.save_for_backward(q, k, v, bias, key_padding_mask, out, lse)
        ctx.causal, ctx.num_heads = causal, num_heads
        ctx.mark_non_differentiable(lse)  # stats only: its cotangent is dropped
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, bias, key_padding_mask, out, lse = ctx.saved_tensors
        if _device_kind(q) == "cpu":
            dq, dk, dv, dbias = attention_bias_backward_reference(
                q, k, v, bias, key_padding_mask, ctx.causal, g, out, lse, ctx.num_heads)
        else:
            dq, dk, dv, dbias = _launch_backward(
                q, k, v, bias, key_padding_mask, ctx.causal, g.contiguous(), out, lse,
                ctx.num_heads, need_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None


def flash_attention_bias_packed_stats(q, k, v, bias: Optional[torch.Tensor],
                                      key_padding_mask: Optional[torch.Tensor],
                                      causal: bool, num_heads: int):
    """(out, lse), differentiable in q, k, v and bias; lse carries no gradient."""
    return _PackedStats.apply(q, k, v, bias, key_padding_mask, causal, num_heads)


def flash_attention_bias_packed(q, k, v, bias: Optional[torch.Tensor],
                                key_padding_mask: Optional[torch.Tensor],
                                causal: bool, num_heads: int):
    """Differentiable packed fused attention, output only."""
    return flash_attention_bias_packed_stats(q, k, v, bias, key_padding_mask, causal, num_heads)[0]
