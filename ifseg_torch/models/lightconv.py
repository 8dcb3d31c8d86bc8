"""Lightweight and dynamic convolutions (Wu et al. 2019), the counterparts of
the JAX package's ``models/lightconv.py`` (the reference's
custom_fairseq/fairseq/modules/{lightconv_layer,dynamicconv_layer}).

Depthwise convolutions over the sequence with softmax-normalised kernels
shared by ``num_heads`` channel groups: static (``LightConv``, a (heads, k)
table) or predicted at each position from the input (``DynamicConv``, a
bias-free ``Linear`` to heads x k).  As in the JAX package they are an
unfold + einsum over (B, L, C) inputs, zero-padded ``(k-1, 0)`` when causal
and ``((k-1)//2, k//2)`` otherwise; weight dropout draws its mask from an
explicit ``torch.Generator`` (``set_generator``), in training mode only.
The JAX module has no Pallas kernel and nothing in either model calls it,
so this one is plain PyTorch too.  The kernels are normalised in fp32 and
applied in the input's dtype.  ``checkpoint/convert.py``'s
``lightconv_state_from_jax`` carries the JAX parameters over.
"""

from typing import Optional

import torch
from torch import nn

from ifseg_torch.models.attention import Dropout, Linear


def _unfold(x: torch.Tensor, kernel_size: int, causal: bool) -> torch.Tensor:
    """x: (B, L, C) -> windows (B, L, K, C) with zero padding."""
    k = kernel_size
    left, right = (k - 1, 0) if causal else ((k - 1) // 2, k // 2)
    xp = nn.functional.pad(x, (0, 0, left, right))
    length = x.shape[1]
    return torch.stack([xp[:, i:i + length] for i in range(k)], dim=2)


class LightConv(nn.Module):
    """Depthwise convolution with softmax-normalised weights (heads, k) shared
    across the ``num_heads`` channel groups (modules/lightconv_layer)."""

    def __init__(self, kernel_size: int = 3, num_heads: int = 4, causal: bool = False,
                 weight_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.num_heads, self.causal = kernel_size, num_heads, causal
        self.weight = nn.Parameter(torch.empty(num_heads, kernel_size))
        self.weight_dropout = Dropout(weight_dropout)

    def init(self, generator: Optional[torch.Generator] = None) -> "LightConv":
        """N(0, 0.1) weights, as the JAX module's initializer."""
        with torch.no_grad():
            self.weight.normal_(0.0, 0.1, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        h, k = self.num_heads, self.kernel_size
        if c % h:
            raise ValueError(f"{c} channels do not split into {h} heads")
        w = self.weight_dropout(torch.softmax(self.weight.float(), dim=-1)).to(x.dtype)
        windows = _unfold(x, k, self.causal).reshape(b, length, k, h, c // h)
        return torch.einsum("blkhd,hk->blhd", windows, w).reshape(b, length, c)


class DynamicConv(nn.Module):
    """Position-specific depthwise convolution: kernels (heads, k) predicted
    from the input by ``weight_linear`` (modules/dynamicconv_layer)."""

    def __init__(self, embed_dim: int, kernel_size: int = 3, num_heads: int = 4,
                 causal: bool = False, weight_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.num_heads, self.causal = kernel_size, num_heads, causal
        self.weight_linear = Linear(embed_dim, num_heads * kernel_size, bias=False)
        self.weight_dropout = Dropout(weight_dropout)

    def init(self, generator: Optional[torch.Generator] = None) -> "DynamicConv":
        """LeCun-normal weights, flax ``Dense``'s default: a normal cut at two
        deviations, scaled to variance 1 / fan_in."""
        std = self.weight_linear.weight.shape[1] ** -0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.weight_linear.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        h, k = self.num_heads, self.kernel_size
        if c % h:
            raise ValueError(f"{c} channels do not split into {h} heads")
        logits = self.weight_linear(x).float().reshape(b, length, h, k)
        w = self.weight_dropout(torch.softmax(logits, dim=-1)).to(x.dtype)
        windows = _unfold(x, k, self.causal).reshape(b, length, k, h, c // h)
        return torch.einsum("blkhd,blhk->blhd", windows, w).reshape(b, length, c)
