"""Exponential moving average of the parameters.

Mirrors fairseq's models/ema/ema.py: a shadow copy of every parameter,
updated as ``ema = decay * ema + (1 - decay) * params`` after each applied
update, kept in fp32 when ``fp32`` is set.
"""

from typing import Dict

import torch
from torch import nn


def ema_init(model: nn.Module, fp32: bool = False) -> Dict[str, torch.Tensor]:
    return {
        name: (p.detach().float() if fp32 else p.detach()).clone()
        for name, p in model.named_parameters()
    }


@torch.no_grad()
def ema_step(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """In place: ``ema = decay * ema + (1 - decay) * params``."""
    shadow = list(ema.values())
    params = [p.detach().to(e.dtype) for e, (_, p) in zip(shadow, model.named_parameters())]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, params, alpha=1.0 - decay)
