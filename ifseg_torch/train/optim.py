"""Optimizer stack of the training step: fairseq-exact Adam, cosine LR,
freezing, gradient clipping.

- ``fairseq_adam`` / ``FairseqAdam``: the update of fairseq's optim/adam.py
  in fp32:  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g²;
  p -= wd*lr*p;  p -= lr*sqrt(1-b2^t)/(1-b1^t) * m/(sqrt(v)+eps),
  with eps outside the bias correction, the learning rate read at the count
  before the increment and the bias correction at the count after it.
- ``cosine_schedule``: one cosine period over ``total_num_updates`` after a
  linear warm-up of ``int(total * warmup_ratio)`` updates.
- ``freeze_mask``: the freezing policy of the run scripts (shared token
  embedding, seg embedding, ResNet, encoder layers), by parameter name.
- ``clip_by_global_norm``: scale the gradients by clip_norm / max(norm,
  clip_norm); returns the norm before clipping.

Parameters and moments are fp32 and the model computes in bf16, whose fp32
exponent range needs no loss scaling.  Only ``adam`` with ``cosine`` is
ported; the other optimizers and schedules of the JAX package are queued.
"""

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def cosine_schedule(lr: float, total_num_updates: int, warmup_ratio: float = 0.0,
                    warmup_updates: int = 0) -> Callable[[int], float]:
    """Linear warm-up from 0 to ``lr``, then one cosine period down to 0."""
    if warmup_ratio > 0:
        warmup_updates = int(total_num_updates * warmup_ratio)

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_updates:
            return step * (lr / max(warmup_updates, 1))
        t_i = max(total_num_updates, 1)  # single period = total updates
        frac = min((step - warmup_updates) / t_i, 1.0)
        return 0.5 * lr * (1.0 + math.cos(math.pi * frac))

    return schedule


class FairseqAdam:
    """Adam over a fixed list of fp32 parameters, updated in place.

    State: ``count`` (updates applied), ``mu`` and ``nu`` (one fp32 tensor per
    parameter)."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def load_state(self, names: Sequence[str], state: Dict) -> None:
        """Take ``count`` and the moments of the parameters named ``names``
        (in this optimizer's order) from ``state`` (``{"count", "mu", "nu"}``,
        the moments as name -> tensor)."""
        self.count = int(state["count"])
        for name, m, v in zip(names, self.mu, self.nu):
            m.copy_(state["mu"][name])
            v.copy_(state["nu"][name])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads`` (one tensor per parameter, same order)."""
        if not self.params:
            return
        b1, b2 = self.b1, self.b2
        t = self.count + 1
        # the scalars in fp32, as the JAX package computes them
        f32 = np.float32
        lr = f32(self.learning_rate(self.count))
        bc = np.sqrt(f32(1.0) - f32(b2) ** f32(t)) / (f32(1.0) - f32(b1) ** f32(t))
        grads = [g.float() for g in grads]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(denom, self.eps)
        # s = lr*bc*m / (sqrt(v)+eps) + wd*lr*p;  p -= s
        update = torch._foreach_mul(self.mu, float(lr * bc))
        torch._foreach_div_(update, denom)
        if self.weight_decay != 0.0:
            torch._foreach_add_(update, self.params, alpha=float(f32(self.weight_decay) * lr))
        torch._foreach_sub_(self.params, update)
        self.count = t


fairseq_adam = FairseqAdam  # the JAX package's name for it


def clip_by_global_norm(grads: Sequence[torch.Tensor], clip_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by clip_norm / max(norm, clip_norm) and return
    the global norm before clipping (fp32 scalar tensor, no host sync)."""
    if not grads:
        return torch.zeros(())
    norms = torch._foreach_norm([g.float() for g in grads])
    gnorm = torch.linalg.vector_norm(torch.stack(norms))
    if clip_norm > 0:
        scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
        torch._foreach_mul_(list(grads), scale)
    return gnorm


def freeze_mask(model: nn.Module, model_cfg) -> Dict[str, bool]:
    """name -> trainable, over ``model.named_parameters()`` (the shared token
    embedding appears once, under its encoder name).

    - freeze_encoder_embedding / freeze_decoder_embedding: the shared
      ``embed_tokens``;
    - freeze_seg_embedding: ``seg_embed_tokens`` and an untied
      ``seg_projection``;
    - freeze_entire_resnet / freeze_resnet: all of ``embed_images``
      (``image_proj`` stays trainable);
    - freeze_encoder_transformer(_layers): the encoder layers, all or the
      first n.
    The FrozenBN statistics are buffers and never train."""

    def trainable(name: str) -> bool:
        segments = name.split(".")
        # exact segment match: as a substring, "embed_tokens" would also catch
        # decoder.seg_embed_tokens and freeze the seg head with it
        if "embed_tokens" in segments and (
            model_cfg.freeze_encoder_embedding or model_cfg.freeze_decoder_embedding
        ):
            return False
        if model_cfg.freeze_seg_embedding and (
            "seg_embed_tokens" in segments or "seg_projection" in segments
        ):
            return False
        if (model_cfg.freeze_entire_resnet or model_cfg.freeze_resnet) and "embed_images" in segments:
            return False
        if name.startswith("encoder.layers."):
            if model_cfg.freeze_encoder_transformer:
                return False
            if int(segments[2]) < model_cfg.freeze_encoder_transformer_layers:
                return False
        return True

    return {name: trainable(name) for name, _ in model.named_parameters()}


def build_optimizer(model: nn.Module, model_cfg, opt_cfg, total_num_updates: int
                    ) -> Tuple[FairseqAdam, Callable[[int], float], Dict[str, bool]]:
    """(optimizer over the trainable parameters, schedule, freeze mask).
    Clipping happens outside: it needs the raw gradient norm for logging."""
    if opt_cfg.lr_scheduler != "cosine":
        raise NotImplementedError(f"lr scheduler {opt_cfg.lr_scheduler!r} is not ported")
    if opt_cfg.optimizer != "adam":
        raise NotImplementedError(f"optimizer {opt_cfg.optimizer!r} is not ported")
    schedule = cosine_schedule(opt_cfg.lr, total_num_updates,
                               warmup_ratio=opt_cfg.warmup_ratio,
                               warmup_updates=opt_cfg.warmup_updates)
    mask = freeze_mask(model, model_cfg)
    params: List[torch.Tensor] = [p for name, p in model.named_parameters() if mask[name]]
    betas = opt_cfg.adam_betas
    optimizer = fairseq_adam(params, schedule, b1=betas[0], b2=betas[1], eps=opt_cfg.adam_eps,
                             weight_decay=opt_cfg.weight_decay)
    return optimizer, schedule, mask
