"""Polynomial GELU, ``--activation-fn=gelu_poly``.

The JAX package's ``ops/gelu.py`` as it computes it: a piecewise fp32
polynomial chosen so that the output rounded to bf16 is at least as accurate
as the fp32 ``0.5*x*(1+erf(x/sqrt2))`` formula:

  x >= 2.765625        y = x              (gelu rounds to x in bf16)
  0 <= x < 2.765625    y = x * P1(x)      (degree-10 shifted polynomials of
  -3 <= x < 0          y = x * P2(x)       R(x) = 0.5*(1+erf(x/sqrt2)))
  -8.3125 <= x < -3    y = 0.5*x*exp(-x^2/2)*P3(x)   (P3 ~ a scaled erfc)
  x < -8.3125          y = -0.0           (gelu rounds to -0 in bf16)

NaN stays NaN.  The JAX package computes it outside any Pallas kernel, as
elementwise XLA ops that XLA fuses, so plain PyTorch is its port; the
coefficient tables below are this package's own copy of that module's.
Eager PyTorch runs the formula as some forty elementwise ops, and autograd
would keep each one's fp32 operands for the backward, tens of tensors of
the FFN's width a layer, which at OFA-Base's training batch do not fit the
card.  So where a gradient flows, ``gelu_poly`` saves only its input and
its backward runs the formula again under autograd: the gradient of the
same ops, one layer's temporaries at a time.
"""

import torch

_HI = 2.765625
_MID0 = 0.0
_MIDLO = -3.0
_LO = -8.3125

_C1 = 1.3828125
_CO1 = (9.16638851e-01, 1.53351665e-01, -1.06028825e-01, 2.33099312e-02,
        9.61673260e-03, -6.14332035e-03, 1.24850689e-04, 6.90554793e-04,
        -1.23178252e-04, -3.93620176e-05, 1.16326446e-05)
_C2 = -1.5
_CO2 = (6.6807158e-02, 1.2951773e-01, 9.7139701e-02, 2.6981678e-02,
        -6.0796058e-03, -5.8661634e-03, -6.4025616e-04, 5.5583240e-04,
        1.5865112e-04, -2.5116018e-05, -1.1997577e-05)
_C3 = -5.65625
_CO3 = (1.3701333e-01, 2.2902543e-02, 3.7335618e-03, 5.9576472e-04,
        9.2910443e-05, 1.3516978e-05, 1.9996703e-06, 4.2738856e-07,
        6.3232072e-08)


def _horner(coef, t):
    """sum coef[i] t^i in fp32, Horner's order from the highest power; each
    Python coefficient meets the fp32 tensor as an fp32 scalar, the value of
    numpy's float32 table."""
    acc = torch.full_like(t, coef[-1])
    for c in coef[-2::-1]:
        acc = acc * t + c
    return acc


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-polynomial gelu; fp32 internal math, returns ``x.dtype``;
    differentiable, keeping only ``x`` for its backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluPoly.apply(x)
    return _gelu_poly(x)


class _GeluPoly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_poly(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            return torch.autograd.grad(_gelu_poly(xd), xd, g)


def _gelu_poly(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    xc = xf.clamp(_LO, _HI)  # keeps the branch math finite for infinite inputs
    mid_pos = xf * _horner(_CO1, xc - _C1)
    mid_neg = xf * _horner(_CO2, xc - _C2)
    tail = 0.5 * xf * torch.exp(-0.5 * xc * xc) * _horner(_CO3, xc - _C3)
    y = torch.where(
        xf >= _HI, xf,
        torch.where(xf >= _MID0, mid_pos,
                    torch.where(xf >= _MIDLO, mid_neg,
                                torch.where(xf >= _LO, tail, torch.full_like(xf, -0.0)))))
    y = torch.where(torch.isnan(xf), xf, y)
    return y.to(x.dtype)
