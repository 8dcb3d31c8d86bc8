"""Optimizer stack of the training step: the JAX package's schedules,
optimizers, composite groups, plateau controller, loss scaler, freezing and
gradient clipping (its ``train/optim.py``), on a fixed list of fp32
parameters updated in place.

Schedules (``build_schedule``; the learning rate at the count of updates
applied before the one it drives):

- ``cosine``: one cosine period over ``total_num_updates`` after a linear
  warm-up of ``int(total * warmup_ratio)`` (or ``warmup_updates``) updates;
- ``inverse_sqrt``: linear warm-up, then ``lr * sqrt(warmup / step)``;
- ``polynomial_decay``: linear warm-up, then (lr - end) * frac**power + end;
- ``fixed``, ``pass_through`` and ``reduce_lr_on_plateau``: the base lr (the
  plateau controller ``ReduceLROnPlateau`` drives an lr scale instead);
- ``triangular``: cycles between lr and max_lr, shrinking per cycle;
- ``tri_stage``: warm-up, hold, exponential decay to 0.01 lr at the end;
- ``manual``: ``--manual-lr-schedule=epoch:lr,...`` from those epochs on.

Optimizers (``build_optimizer``; each returns updates that are added to the
parameters, the arithmetic of the JAX package's optax transform in fp32):

- ``adam``: fairseq's Adam, ``FairseqAdam``:  m = b1*m + (1-b1)*g;
  v = b2*v + (1-b2)*g²;  p -= wd*lr*p + lr*sqrt(1-b2^t)/(1-b1^t) * m/(sqrt(v)+eps);
- ``lamb`` / ``fused_lamb``: Adam moments with bias correction, decoupled
  weight decay and a trust ratio ||p|| / ||u|| per parameter of the JAX tree;
- ``sgd`` and ``nag``: optax's ``sgd`` after ``add_decayed_weights`` (sgd's
  momentum None when 0; nag Nesterov with ``--momentum``);
- ``adagrad`` (accumulator from 0.1, eps 1e-7), ``adadelta`` (rho 0.9, eps
  1e-6), ``adamax`` (eps 1e-8): optax's, with their defaults;
- ``adafactor``: optax's (decay 1 - (t+1)^-0.8, factored above 128 along the
  JAX tree's layout, update clipping 1.0, parameter scale, eps 1e-30 and
  1e-3, ``weight_decay_rate`` = ``--weight-decay`` added after the lr);
- ``composite``: ``--composite-groups=regex=opt@lr,...`` routes parameters by
  the first regex that matches their JAX path (``jax_paths``: the tree paths
  ``encoder/layers_3/self_attn/q_proj/kernel`` the JAX package's regexes
  see), each group with its own optimizer and schedule, the rest to
  ``--composite-base``.

The JAX package's optimizers see its parameter tree: transposed kernels
(flax (in, out) against torch (out, in), HWIO against OIHW) and one stacked
(layers, ...) array for each side's per-layer relative-position tables.
Where an optimizer computes over a whole parameter (lamb's norms,
adafactor's factored moments and block RMS), it computes over that JAX view
(``JaxLeaf``); elementwise ones need no view.

Under ``reduce_lr_on_plateau`` every optimizer's updates are scaled by a
host-set ``lr_scale`` (``LrScaled``), the JAX package's ``with_lr_scale``;
``set_lr_scale`` sets it, or fairseq Adam's own scale without the plateau.
``DynamicLossScaler`` is kept for fp16 parity experiments, as in the JAX
package; bf16 training needs none.  ``freeze_mask`` is the run scripts'
freezing policy by parameter name; ``clip_by_global_norm`` scales the
gradients by clip_norm / max(norm, clip_norm) and returns the norm.
"""

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

f32 = np.float32


# ------------------------------------------------------------------ schedules

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


def inverse_sqrt_schedule(lr: float, warmup_updates: int = 4000,
                          warmup_init_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warm-up, then ``lr * sqrt(warmup / step)``; update 1 runs at
    ``warmup_init_lr``."""
    wu = max(warmup_updates, 1)

    def schedule(step: int) -> float:
        step = float(step)
        if step < wu:
            return warmup_init_lr + step * ((lr - warmup_init_lr) / wu)
        return lr * math.sqrt(wu / max(step, 1.0))

    return schedule


def polynomial_decay_schedule(lr: float, total_num_updates: int, warmup_updates: int = 0,
                              warmup_ratio: float = 0.0, end_learning_rate: float = 0.0,
                              power: float = 1.0) -> Callable[[int], float]:
    """Linear warm-up, then (lr - end) * frac**power + end down to the end of
    ``total_num_updates``."""
    if warmup_ratio > 0:
        warmup_updates = int(total_num_updates * warmup_ratio)

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_updates:
            return lr * min(step / max(warmup_updates, 1), 1.0)
        frac = (total_num_updates - step) / max(total_num_updates - warmup_updates, 1)
        frac = min(max(frac, 0.0), 1.0)
        return (lr - end_learning_rate) * frac ** power + end_learning_rate

    return schedule


def fixed_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def manual_schedule(lr: float, epoch_boundaries=(), epoch_lrs=(),
                    updates_per_epoch: int = 1) -> Callable[[int], float]:
    """Piecewise-constant: the lr of the largest epoch boundary reached (epochs
    1-indexed, epoch e starting at update (e-1) * updates_per_epoch), ``lr``
    before the first."""
    bounds = [(b - 1) * updates_per_epoch for b in epoch_boundaries]
    lrs = (lr,) + tuple(epoch_lrs)

    def schedule(step: int) -> float:
        return lrs[sum(1 for b in bounds if step >= b)]

    return schedule


def triangular_schedule(lr: float, max_lr: float, period: int = 1000,
                        shrink_factor: float = 1.0) -> Callable[[int], float]:
    """Cyclical lr between ``lr`` and ``max_lr``, the peak shrinking by
    ``shrink_factor`` each cycle."""

    def schedule(step: int) -> float:
        step = float(step)
        cycle = math.floor(1.0 + step / (2.0 * period))
        x = abs(step / period - 2.0 * cycle + 1.0)
        shrink = shrink_factor ** (cycle - 1.0)
        return lr + (max_lr * shrink - lr) * max(0.0, 1.0 - x)

    return schedule


def tri_stage_schedule(lr: float, init_lr_scale: float = 0.01, final_lr_scale: float = 0.01,
                       warmup_steps: int = 0, hold_steps: int = 0,
                       decay_steps: int = 0) -> Callable[[int], float]:
    """Warm-up from init_lr_scale * lr, hold at lr, exponential decay to
    final_lr_scale * lr."""
    init_lr = init_lr_scale * lr

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return init_lr + (lr - init_lr) * min(step / max(warmup_steps, 1), 1.0)
        if step < warmup_steps + hold_steps:
            return lr
        frac = min(max(step - warmup_steps - hold_steps, 0.0) / max(decay_steps, 1), 1.0)
        return lr * math.exp(math.log(max(final_lr_scale, 1e-12)) * frac)

    return schedule


class ReduceLROnPlateau:
    """The plateau controller: ``step(metric)`` after each validation; when
    the metric has not improved by ``threshold`` for more than ``patience``
    validations the lr scale shrinks by ``shrink``.  Apply its scale with
    ``Trainer.set_lr_scale``.  Its state (best, bad count, scale) goes into
    the trainer's checkpoints."""

    def __init__(self, shrink: float = 0.1, patience: int = 0, threshold: float = 1e-4,
                 maximize: bool = False):
        self.shrink = shrink
        self.patience = patience
        self.threshold = threshold
        self.maximize = maximize
        self.best = None
        self.bad_count = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        better = (
            self.best is None
            or (self.maximize and metric > self.best + self.threshold)
            or (not self.maximize and metric < self.best - self.threshold)
        )
        if better:
            self.best = metric
            self.bad_count = 0
        else:
            self.bad_count += 1
            if self.bad_count > self.patience:
                self.scale *= self.shrink
                self.bad_count = 0
        return self.scale

    def state_dict(self) -> Dict:
        return dict(best=self.best, bad_count=self.bad_count, scale=self.scale)

    def load_state_dict(self, state: Dict) -> None:
        self.best, self.bad_count, self.scale = state["best"], state["bad_count"], state["scale"]


SCHEDULERS = ("cosine", "inverse_sqrt", "polynomial_decay", "fixed", "pass_through", "manual",
              "triangular", "tri_stage", "reduce_lr_on_plateau")


def build_schedule(name: str, lr: float, total_num_updates: int, opt_cfg=None
                   ) -> Callable[[int], float]:
    """The schedule ``--lr-scheduler=name`` gives, with the knobs of
    ``opt_cfg`` (the JAX package's defaults where it has none)."""
    knob = lambda k, d: getattr(opt_cfg, k, d)
    if name == "cosine":
        return cosine_schedule(lr, total_num_updates, warmup_ratio=knob("warmup_ratio", 0.0),
                               warmup_updates=knob("warmup_updates", 0))
    if name == "inverse_sqrt":
        return inverse_sqrt_schedule(lr, warmup_updates=max(knob("warmup_updates", 0), 1))
    if name == "polynomial_decay":
        return polynomial_decay_schedule(lr, total_num_updates,
                                         warmup_updates=knob("warmup_updates", 0),
                                         warmup_ratio=knob("warmup_ratio", 0.0))
    if name in ("fixed", "pass_through", "reduce_lr_on_plateau"):
        return fixed_schedule(lr)
    if name == "triangular":
        return triangular_schedule(lr, max_lr=knob("max_lr", 0.0) or lr * 10,
                                   period=knob("lr_period_updates", 1000) or 1000,
                                   shrink_factor=knob("lr_shrink", 1.0) or 1.0)
    if name == "tri_stage":
        wu, hold = knob("warmup_updates", 0), knob("hold_updates", 0)
        # the decay spans the rest, so final_lr_scale * lr is reached at the end
        return tri_stage_schedule(lr, warmup_steps=wu, hold_steps=hold,
                                  decay_steps=max(total_num_updates - wu - hold, 1))
    if name == "manual":
        boundaries, lrs = [], []
        for part in filter(None, (p.strip() for p in (knob("manual_lr_schedule", "") or "")
                                  .split(","))):
            ep, _, v = part.partition(":")
            boundaries.append(int(ep))
            lrs.append(float(v))
        max_epoch = max(knob("max_epoch", 1), 1)
        return manual_schedule(lr, boundaries, lrs,
                               updates_per_epoch=max(total_num_updates // max_epoch, 1))
    raise ValueError(f"unknown lr scheduler {name}; known: {sorted(SCHEDULERS)}")


class DynamicLossScaler:
    """Dynamic loss scaling for fp16 parity experiments (bf16 training needs
    none): scale the loss by ``scale`` before the backward, then call
    ``update(overflow)``, which returns True when the step is to be skipped."""

    def __init__(self, init_scale: float = 2.0 ** 7, scale_window: int = 512,
                 scale_factor: float = 2.0, min_loss_scale: float = 1e-4,
                 tolerance: float = 0.0):
        self.scale = init_scale
        self.scale_window = scale_window
        self.scale_factor = scale_factor
        self.min_loss_scale = min_loss_scale
        self.tolerance = tolerance
        self._iter = 0
        self._last_overflow_iter = -1
        self._overflows_since_rescale = 0

    def update(self, overflow: bool) -> bool:
        self._iter += 1
        if overflow:
            self._overflows_since_rescale += 1
            pct = self._overflows_since_rescale / max(self._iter - self._last_overflow_iter, 1)
            if pct >= self.tolerance:
                self.scale = max(self.scale / self.scale_factor, self.min_loss_scale)
                self._last_overflow_iter = self._iter
                self._overflows_since_rescale = 0
            return True
        if (self._iter - self._last_overflow_iter) % self.scale_window == 0:
            self.scale *= self.scale_factor
        return False


# --------------------------------------------------------- the JAX tree's view

class JaxLeaf:
    """One parameter of the JAX package's tree over the port's tensors:
    ``path`` ('/'-joined), ``index`` (positions in the optimizer's list) and
    ``layout``: "same", "linear" (kernel (in, out) = weight.T), "conv"
    (HWIO = OIHW.permute(2, 3, 1, 0)) or "stacked" (the per-layer tables,
    stacked in layer order)."""

    def __init__(self, path: str, index: List[int], layout: str):
        self.path, self.index, self.layout = path, index, layout

    def view(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The leaf's tensor in the JAX layout (a copy only when stacked)."""
        if self.layout == "stacked":
            return torch.stack([tensors[i] for i in self.index])
        t = tensors[self.index[0]]
        if self.layout == "linear":
            return t.t()
        if self.layout == "conv":
            return t.permute(2, 3, 1, 0)
        return t

    def unview(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A JAX-layout tensor as the port's tensors, in ``index`` order."""
        if self.layout == "stacked":
            return list(x.unbind(0))
        if self.layout == "linear":
            return [x.t()]
        if self.layout == "conv":
            return [x.permute(3, 2, 0, 1)]
        return [x]


_REL_TABLE = re.compile(r"^(encoder|decoder)\.(\w+_rel_pos_table)_list\.(\d+)\.weight$")
_FFN = ("fc1", "fc2", "ffn_layernorm")


def jax_paths(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """Parameter name -> (its path in the JAX package's tree, layout), for
    every parameter of ``model`` (the inverse of ``state_dict_from_jax``'s
    naming).  The decoder's image position table, which only the port
    holds, gets the path it would have there."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            m = _REL_TABLE.match(name)
            if m:
                out[name] = (f"{m.group(1)}/{m.group(2)}", "stacked")
                continue
            parts = mname.split(".")
            if parts[-1] == "embed_tokens":
                out[name] = ("embed_tokens/embedding", "same")
                continue
            if len(parts) > 1 and parts[1].endswith("_prompt_encoder"):
                # <side>.<side>_prompt_encoder.{embedding,trans.0,trans.2}
                # -> <side>/prompt_encoder/{embedding,trans_0,trans_2}
                leaf = {"embedding": "embedding/embedding",
                        "trans.0": "trans_0", "trans.2": "trans_2"}[".".join(parts[2:])]
                if leaf != "embedding/embedding":
                    leaf += "/kernel" if pname == "weight" else f"/{pname}"
                out[name] = (f"{parts[0]}/prompt_encoder/{leaf}",
                             "linear" if leaf.endswith("/kernel") else "same")
                continue
            path = []
            i = 0
            while i < len(parts):
                p = parts[i]
                if p == "layers" and i + 1 < len(parts):
                    path.append(f"layers_{parts[i + 1]}")
                    i += 2
                    if i < len(parts) and parts[i] in _FFN:
                        path.append("ffn")
                    continue
                if re.fullmatch(r"layer\d", p) and i + 1 < len(parts):
                    path.append(f"{p}_{parts[i + 1]}")
                    i += 2
                    continue
                if p == "downsample" and i + 1 < len(parts):
                    path.append("downsample_conv" if parts[i + 1] == "0" else "downsample_bn")
                    i += 2
                    continue
                path.append(p)
                i += 1
            layout = "same"
            if isinstance(mod, nn.Linear):
                leaf = "kernel" if pname == "weight" else pname
                layout = "linear" if pname == "weight" else "same"
            elif isinstance(mod, nn.Conv2d):
                leaf, layout = "kernel", "conv"
            elif isinstance(mod, nn.LayerNorm):
                leaf = "scale" if pname == "weight" else pname
            elif isinstance(mod, nn.Embedding):
                # the seg tables are raw parameters in the JAX package
                leaf = None if parts[-1] in ("seg_embed_tokens", "seg_projection") else "embedding"
            else:
                leaf = pname
            out[name] = ("/".join(path + ([leaf] if leaf else [])), layout)
    return out


def jax_leaves(names: Sequence[str], paths: Dict[str, Tuple[str, str]]) -> List[JaxLeaf]:
    """The JAX leaves over the parameters ``names`` (an optimizer's list), in
    the order of their first parameter."""
    leaves: Dict[str, JaxLeaf] = {}
    for i, name in enumerate(names):
        path, layout = paths[name]
        if path in leaves:
            leaves[path].index.append(i)
        else:
            leaves[path] = JaxLeaf(path, [i], layout)
    return list(leaves.values())


# ----------------------------------------------------------------- optimizers

def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class Optimizer:
    """An optimizer over a fixed list of fp32 parameters: ``update(grads)``
    returns the updates (one tensor per parameter, to be added) and advances
    the state, ``step(grads)`` adds them.  ``count`` counts the updates; the
    learning rate of an update is the schedule at the count before it.
    ``state_keys`` name the per-parameter state lists, saved by ``keys``
    (parameter names, or JAX paths for a per-leaf state)."""

    state_keys: Tuple[str, ...] = ()

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: Callable[[int], float],
                 names: Optional[Sequence[str]] = None):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.names = list(names) if names is not None else [str(i) for i in range(len(self.params))]
        self.keys = self.names
        self.count = 0

    def _lr(self):
        return f32(self.learning_rate(self.count))

    def update(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if self.params:
            torch._foreach_add_(self.params, self.update(grads))

    def state_dict(self) -> Dict:
        out = {"count": self.count}
        for k in self.state_keys:
            out[k] = {key: _host(t) for key, t in zip(self.keys, getattr(self, k))}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for k in self.state_keys:
            for key, t in zip(self.keys, getattr(self, k)):
                t.copy_(state[k][key])

    def _zeros(self):
        return [torch.zeros_like(p, dtype=torch.float32) for p in self.params]


class FairseqAdam(Optimizer):
    """fairseq's Adam, with eps outside the bias correction, the learning rate
    read at the count before the increment and the bias correction at the
    count after it, times ``lr_scale`` (1 unless ``set_lr_scale`` sets it).
    State: ``count``, ``mu`` and ``nu``."""

    state_keys = ("mu", "nu")

    def __init__(self, params, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, names=None):
        super().__init__(params, learning_rate, names)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.lr_scale = 1.0
        self.mu, self.nu = self._zeros(), self._zeros()

    def state_dict(self) -> Dict:
        return dict(super().state_dict(), lr_scale=self.lr_scale)

    def load_state_dict(self, state: Dict) -> None:
        super().load_state_dict(state)
        self.lr_scale = float(state.get("lr_scale", 1.0))

    def _descent(self, grads) -> List[torch.Tensor]:
        """The step s of p -= s, advancing the moments and the count."""
        b1, b2 = self.b1, self.b2
        t = self.count + 1
        # the scalars in fp32, as the JAX package computes them
        lr = self._lr() * f32(self.lr_scale)
        bc = np.sqrt(f32(1.0) - f32(b2) ** f32(t)) / (f32(1.0) - f32(b1) ** f32(t))
        grads = [g.float() for g in grads]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(denom, self.eps)
        # s = lr*bc*m / (sqrt(v)+eps) + wd*lr*p
        s = torch._foreach_mul(self.mu, float(lr * bc))
        torch._foreach_div_(s, denom)
        if self.weight_decay != 0.0:
            torch._foreach_add_(s, self.params, alpha=float(f32(self.weight_decay) * lr))
        self.count = t
        return s

    @torch.no_grad()
    def update(self, grads):
        s = self._descent(grads)
        torch._foreach_neg_(s)
        return s

    @torch.no_grad()
    def step(self, grads) -> None:
        if self.params:
            torch._foreach_sub_(self.params, self._descent(grads))


fairseq_adam = FairseqAdam  # the JAX package's name for it


class Lamb(Optimizer):
    """LAMB (apex FusedLAMB): Adam moments with bias correction, u = m̂ /
    (sqrt(v̂) + eps) + wd*p, the update -lr * trust * u with trust = ||p|| /
    ||u|| over each JAX leaf (1 where either is 0)."""

    state_keys = ("mu", "nu")

    def __init__(self, params, learning_rate, leaves: List[JaxLeaf], b1=0.9, b2=0.999,
                 eps=1e-6, weight_decay=0.0, names=None):
        super().__init__(params, learning_rate, names)
        self.leaves, self.b1, self.b2, self.eps, self.weight_decay = leaves, b1, b2, eps, weight_decay
        self.mu, self.nu = self._zeros(), self._zeros()

    @torch.no_grad()
    def update(self, grads):
        b1, b2 = self.b1, self.b2
        t = f32(self.count + 1)
        lr = self._lr()
        grads = [g.float() for g in grads]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        u = torch._foreach_div(self.mu, float(f32(1.0) - f32(b1) ** t))
        den = torch._foreach_div(self.nu, float(f32(1.0) - f32(b2) ** t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.weight_decay != 0.0:
            torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        # the norms accumulated in fp64: fp32 accumulation on the CPU drifts
        # by 4e-5 at a 768 x 3072 weight (3e-3 at 45M elements)
        pn = torch._foreach_norm(self.params, 2, dtype=torch.float64)
        un = torch._foreach_norm(u, 2, dtype=torch.float64)
        for leaf in self.leaves:
            p_norm = torch.stack([pn[i] for i in leaf.index]).square().sum().sqrt()
            u_norm = torch.stack([un[i] for i in leaf.index]).square().sum().sqrt()
            ok = (p_norm > 0.0) & (u_norm > 0.0)
            trust = torch.where(ok, p_norm / torch.where(ok, u_norm, 1.0), 1.0).float()
            torch._foreach_mul_([u[i] for i in leaf.index], trust * float(-lr))
        self.count += 1
        return u


class Sgd(Optimizer):
    """optax's sgd after ``add_decayed_weights``: g' = g + wd*p; with a
    momentum, t = g' + momentum*t and the direction t (g' + momentum*t
    under Nesterov); the update -lr times it."""

    def __init__(self, params, learning_rate, momentum: Optional[float] = None,
                 nesterov: bool = False, weight_decay: float = 0.0, names=None):
        super().__init__(params, learning_rate, names)
        self.momentum, self.nesterov, self.weight_decay = momentum, nesterov, weight_decay
        self.trace = self._zeros() if momentum is not None else []
        self.state_keys = ("trace",) if momentum is not None else ()

    @torch.no_grad()
    def update(self, grads):
        g = [x.float() for x in grads]
        if self.weight_decay:
            g = torch._foreach_add(g, self.params, alpha=self.weight_decay)
        if self.momentum is not None:
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, g)
            if self.nesterov:
                g = torch._foreach_add(g, self.trace, alpha=self.momentum)
            else:
                g = [t.clone() for t in self.trace]
        else:
            g = [x.clone() for x in g]
        torch._foreach_mul_(g, float(-self._lr()))
        self.count += 1
        return g


class Adagrad(Optimizer):
    """optax's adagrad: s += g²; the update -lr * g / sqrt(s + eps)."""

    state_keys = ("sum_of_squares",)

    def __init__(self, params, learning_rate, initial_accumulator_value=0.1, eps=1e-7, names=None):
        super().__init__(params, learning_rate, names)
        self.eps = eps
        self.sum_of_squares = [torch.full_like(p, initial_accumulator_value, dtype=torch.float32)
                               for p in self.params]

    @torch.no_grad()
    def update(self, grads):
        g = [x.float() for x in grads]
        torch._foreach_addcmul_(self.sum_of_squares, g, g)
        inv = torch._foreach_add(self.sum_of_squares, self.eps)
        torch._foreach_rsqrt_(inv)
        inv = [torch.where(s > 0, r, 0.0) for s, r in zip(self.sum_of_squares, inv)]
        torch._foreach_mul_(inv, g)
        torch._foreach_mul_(inv, float(-self._lr()))
        self.count += 1
        return inv


class Adadelta(Optimizer):
    """optax's adadelta: e_g = rho*e_g + (1-rho)*g²; u = sqrt(e_x + eps) /
    sqrt(e_g + eps) * g; e_x = rho*e_x + (1-rho)*u²; the update -lr * u."""

    state_keys = ("e_g", "e_x")

    def __init__(self, params, learning_rate, rho=0.9, eps=1e-6, names=None):
        super().__init__(params, learning_rate, names)
        self.rho, self.eps = rho, eps
        self.e_g, self.e_x = self._zeros(), self._zeros()

    @torch.no_grad()
    def update(self, grads):
        rho = self.rho
        g = [x.float() for x in grads]
        self.e_g = [(1 - rho) * (x * x) + rho * t for x, t in zip(g, self.e_g)]
        u = [torch.sqrt(ex + self.eps) / torch.sqrt(eg + self.eps) * x
             for x, eg, ex in zip(g, self.e_g, self.e_x)]
        self.e_x = [(1 - rho) * (x * x) + rho * t for x, t in zip(u, self.e_x)]
        torch._foreach_mul_(u, float(-self._lr()))
        self.count += 1
        return u


class Adamax(Optimizer):
    """optax's adamax: m = b1*m + (1-b1)*g; v = max(|g| + eps, b2*v); the
    update -lr * m / (1 - b1^t) / v."""

    state_keys = ("mu", "nu")

    def __init__(self, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, names=None):
        super().__init__(params, learning_rate, names)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu, self.nu = self._zeros(), self._zeros()

    @torch.no_grad()
    def update(self, grads):
        b1, b2 = self.b1, self.b2
        g = [x.float() for x in grads]
        self.mu = [(1 - b1) * x + b1 * m for x, m in zip(g, self.mu)]
        self.nu = [torch.maximum(x.abs() + self.eps, b2 * v) for x, v in zip(g, self.nu)]
        bc = float(f32(1.0) - f32(b1) ** f32(self.count + 1))
        u = [m / bc / v for m, v in zip(self.mu, self.nu)]
        torch._foreach_mul_(u, float(-self._lr()))
        self.count += 1
        return u


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice of the (second largest, largest) axes to factor."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """optax's adafactor over the JAX leaves: factored (or full) second
    moments with decay 1 - (t+1)^-0.8 of g² + eps, the rescaled gradient
    clipped to block RMS 1, times the lr and the leaf's RMS (at least 1e-3),
    plus ``weight_decay_rate`` * p, negated.  The factored axes are chosen
    on the JAX layout, as there.  State per leaf, by JAX path: ``v_row``,
    ``v_col``, ``v`` (optax's placeholders of shape (1,) where unused)."""

    state_keys = ("v_row", "v_col", "v")

    def __init__(self, params, learning_rate, leaves: List[JaxLeaf],
                 weight_decay_rate: Optional[float] = None, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0, eps: float = 1e-30,
                 min_scale: float = 1e-3, names=None):
        super().__init__(params, learning_rate, names)
        self.leaves = leaves
        self.keys = [leaf.path for leaf in leaves]
        self.weight_decay_rate, self.decay_rate = weight_decay_rate, decay_rate
        self.clipping_threshold, self.eps, self.min_scale = clipping_threshold, eps, min_scale
        self.dims, self.v_row, self.v_col, self.v = [], [], [], []
        for leaf in leaves:
            x = leaf.view(self.params)
            dims = _factored_dims(tuple(x.shape), min_dim_size_to_factor)
            self.dims.append(dims)
            one = torch.zeros(1, dtype=torch.float32, device=x.device)
            if dims is None:
                self.v_row.append(one)
                self.v_col.append(one.clone())
                self.v.append(torch.zeros(x.shape, dtype=torch.float32, device=x.device))
            else:
                d1, d0 = dims
                self.v_row.append(torch.zeros(np.delete(x.shape, d0).tolist(),
                                              dtype=torch.float32, device=x.device))
                self.v_col.append(torch.zeros(np.delete(x.shape, d1).tolist(),
                                              dtype=torch.float32, device=x.device))
                self.v.append(one.clone())

    @torch.no_grad()
    def update(self, grads):
        t = f32(self.count + 1)
        decay = f32(1.0) - t ** f32(-self.decay_rate)
        decay, keep = float(decay), float(f32(1.0) - decay)  # both in fp32, as optax's
        lr = float(self._lr())
        out: List[Optional[torch.Tensor]] = [None] * len(self.params)
        for j, leaf in enumerate(self.leaves):
            g = leaf.view(grads).float()
            p = leaf.view(self.params)
            g2 = g * g + self.eps
            dims = self.dims[j]
            if dims is None:
                self.v[j] = decay * self.v[j] + keep * g2
                u = g * self.v[j] ** -0.5
            else:
                d1, d0 = dims
                self.v_row[j] = decay * self.v_row[j] + keep * g2.mean(d0)
                self.v_col[j] = decay * self.v_col[j] + keep * g2.mean(d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = self.v_row[j].mean(reduced_d1, keepdim=True)
                row_factor = (self.v_row[j] / row_col_mean) ** -0.5
                col_factor = self.v_col[j] ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            u = u / torch.clamp(u.square().mean().sqrt() / self.clipping_threshold, min=1.0)
            u = lr * u
            rms = p.square().mean().sqrt()
            u = u * torch.where(rms <= self.min_scale, self.min_scale, rms)
            if self.weight_decay_rate is not None:
                u = u + self.weight_decay_rate * p
            for i, x in zip(leaf.index, leaf.unview(-1.0 * u)):
                out[i] = x
        self.count += 1
        return out


class Composite(Optimizer):
    """Parameter groups with optimizers of their own: ``members`` is a list of
    (label, optimizer over a subset, the subset's positions in ``params``).
    Every member steps at every update, as optax's ``multi_transform`` does,
    so their counts stay together.  Saved by label."""

    def __init__(self, params, members, names=None):
        super().__init__(params, lambda step: 0.0, names)
        self.members = members

    @torch.no_grad()
    def update(self, grads):
        out = [None] * len(self.params)
        for _, opt, idx in self.members:
            if not idx:
                opt.count += 1
                continue
            for i, u in zip(idx, opt.update([grads[i] for i in idx])):
                out[i] = u
        self.count += 1
        return out

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "groups": {label: opt.state_dict() for label, opt, _ in self.members}}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for label, opt, _ in self.members:
            opt.load_state_dict(state["groups"][label])


class LrScaled(Optimizer):
    """``inner``'s updates times ``lr_scale``, set from the host (the plateau
    controller's lever, for every optimizer)."""

    def __init__(self, inner: Optimizer):
        self.inner, self.lr_scale = inner, 1.0
        self.params, self.names = inner.params, inner.names
        self.learning_rate = inner.learning_rate

    @property
    def count(self):
        return self.inner.count

    @torch.no_grad()
    def update(self, grads):
        u = self.inner.update(grads)
        torch._foreach_mul_(u, float(f32(self.lr_scale)))
        return u

    def state_dict(self) -> Dict:
        return dict(self.inner.state_dict(), lr_scale=self.lr_scale)

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state)
        self.lr_scale = float(state.get("lr_scale", 1.0))


def set_lr_scale(opt: Optimizer, scale: float) -> None:
    """Apply a plateau decision: the scale of ``LrScaled`` (any optimizer),
    else fairseq Adam's own scale wherever it is (a composite's groups too)."""
    if isinstance(opt, (LrScaled, FairseqAdam)):
        opt.lr_scale = scale
    elif isinstance(opt, Composite):
        for _, member, _ in opt.members:
            set_lr_scale(member, scale)


OPTIMIZERS = ("adam", "adafactor", "lamb", "fused_lamb", "sgd", "nag", "adagrad", "adadelta",
              "adamax", "composite")


def _single_optimizer(name: str, params, names, schedule, opt_cfg, paths) -> Optimizer:
    """One optimizer by the reference's name over ``params``."""
    wd = getattr(opt_cfg, "weight_decay", 0.0)
    betas = getattr(opt_cfg, "adam_betas", (0.9, 0.999))
    leaves = lambda: jax_leaves(names, paths)
    if name == "adam":
        return FairseqAdam(params, schedule, b1=betas[0], b2=betas[1],
                           eps=getattr(opt_cfg, "adam_eps", 1e-8), weight_decay=wd, names=names)
    if name == "adafactor":
        return Adafactor(params, schedule, leaves(), weight_decay_rate=wd or None, names=names)
    if name in ("lamb", "fused_lamb"):
        return Lamb(params, schedule, leaves(), b1=betas[0], b2=betas[1], weight_decay=wd,
                    names=names)
    if name == "sgd":
        return Sgd(params, schedule, momentum=getattr(opt_cfg, "momentum", 0.0) or None,
                   weight_decay=wd, names=names)
    if name == "nag":
        return Sgd(params, schedule, momentum=getattr(opt_cfg, "momentum", 0.99), nesterov=True,
                   weight_decay=wd, names=names)
    if name == "adagrad":
        return Adagrad(params, schedule, names=names)
    if name == "adadelta":
        return Adadelta(params, schedule, names=names)
    if name == "adamax":
        return Adamax(params, schedule, b1=betas[0], b2=betas[1], names=names)
    raise ValueError(f"unknown optimizer {name}; known: {sorted(OPTIMIZERS)}")


def parse_composite_groups(spec: str):
    """``regex=opt@lr,regex=opt@lr,...`` -> [(regex, opt, lr or None)].  The
    first regex that matches wins; parameters no group matches go to the
    base optimizer.  Commas inside ``{...}`` belong to regex quantifiers
    (``layers_[0-9]{1,2}``) and do not split groups."""
    groups = []
    for part in filter(None, (p.strip() for p in re.split(r",(?![^{]*\})", spec))):
        pattern, rhs = part.split("=", 1)
        opt, _, lr = rhs.partition("@")
        groups.append((pattern, opt, float(lr) if lr else None))
    return groups


def composite_labels(names: Sequence[str], paths: Dict[str, Tuple[str, str]], groups
                     ) -> List[str]:
    """Each parameter's group: "g{i}" of the first regex that matches its JAX
    path, else "base"."""
    compiled = [(re.compile(p), f"g{i}") for i, (p, _, _) in enumerate(groups)]

    def label(name):
        path = paths[name][0]
        return next((lab for rx, lab in compiled if rx.search(path)), "base")

    return [label(n) for n in names]


def composite(params, names, paths, groups, base_name: str, opt_cfg,
              total_num_updates: int) -> Composite:
    """The groups of ``parse_composite_groups`` over ``params``, each with its
    optimizer and a schedule of the configured kind at its own lr."""
    sched_for = lambda lr: build_schedule(getattr(opt_cfg, "lr_scheduler", "cosine"), lr,
                                          total_num_updates, opt_cfg)
    labels = composite_labels(names, paths, groups)
    specs = [("base", base_name, opt_cfg.lr)] + [
        (f"g{i}", opt, opt_cfg.lr if lr is None else lr) for i, (_, opt, lr) in enumerate(groups)]
    members = []
    for label, opt_name, lr in specs:
        idx = [i for i, lab in enumerate(labels) if lab == label]
        members.append((label, _single_optimizer(
            opt_name, [params[i] for i in idx], [names[i] for i in idx], sched_for(lr), opt_cfg,
            paths), idx))
    return Composite(params, members, names)


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
    embedding appears once, under its encoder name): the JAX package's rules
    (``freeze_mask``), in its order of precedence, on the port's names.

    - bitfit: only the biases of the LayerNorms named ``*layer_norm`` (each
      layer's self_attn_, encoder_attn_ and final_layer_norm, and each
      side's closing layer_norm) and of fc1 / fc2 train; it overrides every
      other rule (reference train.py:101-107);
    - prefix tuning (encoder_prompt or decoder_prompt): only the prompt
      encoders train, and the adapters when they are on
      (unify_transformer.py:378-390);
    - adapter: the shared ``embed_tokens`` freezes (:366-371);
    - freeze_encoder_embedding / freeze_decoder_embedding: the shared
      ``embed_tokens``;
    - freeze_seg_embedding: ``seg_embed_tokens`` and an untied
      ``seg_projection``;
    - freeze_entire_resnet / freeze_resnet: all of ``embed_images``
      (``image_proj`` stays trainable);
    - freeze_encoder_transformer(_layers): the encoder layers, all or the
      first n.
    The FrozenBN statistics are buffers and never train."""
    prompt_tuning = model_cfg.encoder_prompt or model_cfg.decoder_prompt

    def trainable(name: str) -> bool:
        segments = name.split(".")
        module = segments[-2] if len(segments) > 1 else ""
        if model_cfg.bitfit:
            return segments[-1] == "bias" and (
                module.endswith("layer_norm") or module in ("fc1", "fc2"))
        if prompt_tuning:
            return (any(seg.endswith("_prompt_encoder") for seg in segments)
                    or (model_cfg.adapter and "adapter" in segments))
        # exact segment match: as a substring, "embed_tokens" would also catch
        # decoder.seg_embed_tokens and freeze the seg head with it
        if "embed_tokens" in segments and (
            model_cfg.adapter or model_cfg.freeze_encoder_embedding
            or model_cfg.freeze_decoder_embedding
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
                    ) -> Tuple[Optimizer, Callable[[int], float], Dict[str, bool]]:
    """(optimizer over the trainable parameters, the schedule of the base lr,
    freeze mask).  Clipping happens outside: it needs the raw gradient norm
    for logging."""
    scheduler = getattr(opt_cfg, "lr_scheduler", "cosine")
    schedule = build_schedule(scheduler, opt_cfg.lr, total_num_updates, opt_cfg)
    mask = freeze_mask(model, model_cfg)
    named = [(name, p) for name, p in model.named_parameters() if mask[name]]
    names, params = [n for n, _ in named], [p for _, p in named]
    paths = jax_paths(model)
    name = getattr(opt_cfg, "optimizer", "adam")
    if name == "composite":
        optimizer = composite(params, names, paths,
                              parse_composite_groups(getattr(opt_cfg, "composite_groups", "")),
                              getattr(opt_cfg, "composite_base", "adam"), opt_cfg,
                              total_num_updates)
    else:
        optimizer = _single_optimizer(name, params, names, schedule, opt_cfg, paths)
    if scheduler == "reduce_lr_on_plateau":
        optimizer = LrScaled(optimizer)
    return optimizer, schedule, mask
