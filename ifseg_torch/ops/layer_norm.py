"""One-pass LayerNorm over the last axis.

The port of the JAX package's ``ops/layer_norm.py``, with its names:

``fused_layer_norm(x, scale, bias, eps, out_dtype)``   fp32 row statistics
    with the fast variance E[x²] − E[x]² (flax's formula), the result written
    once in ``out_dtype``; differentiable in x, scale and bias;
``layer_norm_reference``                               the plain version.

x is bf16 or fp32 of any leading shape, scale and bias are fp32 (D,), the
output is bf16 or fp32.  On a CUDA tensor the forward launches the
hand-written Hopper kernel ``csrc/layer_norm.cu`` (or raises: widths are the
multiples of 8 up to 16,384, a warp a row up to 4,096 and a CTA a row above,
where SegOFA-Huge's 5,120-wide ``ffn_layernorm`` falls); on a CPU tensor it
runs the plain version, which is also what the kernel is held against on the
card.  The backward is plain
math from the saved input (the row statistics are recomputed), as in the JAX
package, which has no backward kernel either.

The model's ``LayerNorm`` module calls this op only where no gradient is
needed.  The differentiable route (``_FusedLayerNorm``) is the counterpart of
the JAX op's ``custom_vjp`` and is held to it by the tests, but no model code
takes it yet: its plain backward loses to ``F.layer_norm``'s fused one, so the
training forward stays on ``F.layer_norm`` until this kernel has a backward
kernel beside it.
"""

import ctypes

import torch

from ifseg_torch.ops import build

KERNEL = "layer_norm"  # csrc/layer_norm.cu
# the kernel keeps a row in registers: one warp's up to 4,096, one CTA's
# (256 threads) above, up to this
MAX_WIDTH = 16384
WARP_MAX_WIDTH = 4096  # the widest row of the warp-per-row kernel
_DTYPES = (torch.bfloat16, torch.float32)

# kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): all of them, and those of the CTA-per-row kernel (rows wider than
# WARP_MAX_WIDTH) among them
LAUNCHES = 0
LAUNCHES_WIDE = 0


def reset_launches():
    global LAUNCHES, LAUNCHES_WIDE
    LAUNCHES = LAUNCHES_WIDE = 0


# ------------------------------------------------------------ plain version

def _row_stats(x32, eps):
    """(mu, rsqrt(var + eps)) of each row, fast variance, fp32."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    return mu, torch.rsqrt(var + eps)


def _ln_math(x32, scale, bias, eps):
    mu, r = _row_stats(x32, eps)
    return (x32 - mu) * r * scale + bias


def layer_norm_reference(x, scale, bias, eps: float = 1e-5, out_dtype=torch.float32):
    """Plain version: fp32 upcast, fast-variance statistics, one cast."""
    return _ln_math(x.float(), scale.float(), bias.float(), eps).to(out_dtype)


def layer_norm_backward_reference(x, scale, dy, eps: float):
    """(dx, dscale, dbias) from the saved input, the math of the JAX
    package's ``_ln_bwd``: dx in x's dtype, dscale and dbias fp32."""
    x32 = x.float()
    mu, r = _row_stats(x32, eps)
    xhat = (x32 - mu) * r
    dy32 = dy.float()
    red = tuple(range(dy32.dim() - 1))
    dbias = dy32.sum(dim=red)
    dscale = (dy32 * xhat).sum(dim=red)
    t = dy32 * scale.float()
    dx = r * (t - t.mean(dim=-1, keepdim=True)
              - xhat * (t * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale, dbias


# ------------------------------------------------------------------- launch

def _check(x, scale, bias, out_dtype):
    """Raise on anything the kernel does not take."""
    d = x.shape[-1] if x.dim() else 0
    if d < 8 or d % 8 or d > MAX_WIDTH:
        raise ValueError(f"layer_norm kernel: width {d} is not a multiple of 8 in [8, {MAX_WIDTH}]")
    if x.numel() == 0:
        raise ValueError("layer_norm kernel: empty input")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"layer_norm kernel: x {x.dtype} -> {out_dtype}; bfloat16 or float32 only")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (d,):
            raise ValueError(f"layer_norm kernel: {name} must be float32 ({d},), "
                             f"got {p.dtype} {tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError(f"layer_norm kernel: {name} is on {p.device}, x on {x.device}")
    for name, p in (("x", x), ("scale", scale), ("bias", bias)):
        if not p.is_contiguous():
            raise ValueError(f"layer_norm kernel: {name} must be contiguous")
        if p.data_ptr() % 16:
            raise ValueError(f"layer_norm kernel: {name} must be 16-byte aligned")


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _I, _I, _P]
_ENTRY = []  # the C entry, bound once: a forward calls it at every LayerNorm


def _entry():
    if not _ENTRY:
        fn = build.load(KERNEL).layer_norm_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _launch(x, scale, bias, eps, out_dtype):
    global LAUNCHES, LAUNCHES_WIDE
    x = x.contiguous()
    scale, bias = scale.detach().contiguous(), bias.detach().contiguous()
    _check(x, scale, bias, out_dtype)
    d = x.shape[-1]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel() // d, d, float(eps), int(x.dtype == torch.float32),
            int(out_dtype == torch.float32))
    fn = _entry()
    if x.device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_fwd launch failed: cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_WIDE += int(d > WARP_MAX_WIDTH)
    return y


def _forward(x, scale, bias, eps, out_dtype):
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, scale, bias, eps, out_dtype)


# --------------------------------------------------------------- entry point

class _FusedLayerNorm(torch.autograd.Function):
    """Kernel (CUDA) or plain (CPU) forward; plain backward from the saved
    input and scale."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward_reference(x, scale, dy, ctx.eps)
        return dx, dscale, dbias, None, None


def fused_layer_norm(x, scale, bias, eps: float = 1e-5, out_dtype=torch.float32):
    """LayerNorm over the last axis; fp32 statistics, output in ``out_dtype``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _FusedLayerNorm.apply(x, scale, bias, eps, out_dtype)
    return _forward(x, scale, bias, eps, out_dtype)  # nothing to save
