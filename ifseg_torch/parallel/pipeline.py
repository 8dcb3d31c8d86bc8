"""Pipeline parallelism: the GPipe schedule over the model axis.

The JAX package's ``parallel/pipeline.py``: stage s of the S ranks of the
'model' group runs its layers on M microbatches of its data shard's rows,
the activations passing from stage to stage (``comm``'s ppermute, one
packed buffer a tick) over T = M + S − 1 ticks: at tick t stage s works on
microbatch t − s, the bubble at both ends.  Each data shard splits its own
rows, so data parallelism composes without moving rows.

    out = gpipe(stage_fn, carried, group, chunks=M, mb_consts=..., stage_consts=...,
                bcast=..., modules=...)

- ``carried``: float tensors (rows, ...), the same on every stage, what the
  stages transform; ``stage_fn`` returns tensors of the same shapes.
- ``mb_consts``: tensors (rows, ...) each stage reads for its microbatch
  (masks, the encoder context); they never travel.
- ``stage_consts``: tensors (S, ...), stage s reading its ``[s]`` (a bias
  pack of its layers); ``bcast``: tensors every stage reads whole.
- ``modules``: this stage's modules, whose parameters it trains.

``stage_fn(carry, mb_row, consts, bcast, mb)`` gets lists of tensors (the
microbatch's carry and ``mb_consts`` rows, this stage's consts, ``bcast``)
and the microbatch index.  The last stage's outputs are made whole on
every stage (a broadcast).  M is clamped to gcd(M, rows) with the JAX
package's warning.

With a gradient the schedule is one autograd function whose backward runs
the reverse schedule by hand (each stage's microbatches backward in
reverse tick order, the input gradients passed back one packed ppermute a
tick), so every rank calls the same collectives in the same order whatever
its stage.  The inputs' gradients are made whole on every rank by one
all-reduce a dtype: the carried input's (stage 0's), ``mb_consts`` and
``bcast`` (each stage's part summed) and ``stage_consts`` (each stage's
slice).  The parameters of ``modules`` get this stage's gradients only; the
trainer sums the layers' gradients over the model axis.  Inside the
function the parameters are read as detached copies, so the gradients
reach them (or the whole tensors of FSDP's gather) through the function's
own outputs.
"""

import logging
import math
from contextlib import contextmanager
from typing import Callable, List, Sequence

import torch

from .comm import _ppermute, all_reduce, broadcast_from, group_rank, group_size

logger = logging.getLogger(__name__)


def _pack(ts: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    """One flat buffer of ``dtype`` (the single tensor itself, flattened)."""
    return torch.cat([t.to(dtype).reshape(-1) for t in ts]) if len(ts) > 1 else ts[0].reshape(-1)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, off = [], 0
    for t in like:
        out.append(buf[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def _params(modules) -> List[tuple]:
    """(module, name) of every parameter slot of ``modules``."""
    return [(m, k) for mod in modules for m in mod.modules()
            for k, t in m._parameters.items() if t is not None]


@contextmanager
def _reading(slots, tensors):
    """The modules read ``tensors`` in their parameter slots for the block."""
    old = [m._parameters[k] for m, k in slots]
    try:
        for (m, k), t in zip(slots, tensors):
            m._parameters[k] = t
        yield
    finally:
        for (m, k), t in zip(slots, old):
            m._parameters[k] = t


class _Spec:
    """What the autograd function needs besides its tensors."""

    def __init__(self, stage_fn, group, m, counts, slots):
        self.stage_fn, self.group, self.m = stage_fn, group, m
        self.counts, self.slots = counts, slots  # (carried, mb_consts, stage_consts, bcast, params)
        self.s, self.me = max(group_size(group), 1), group_rank(group)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(t.requires_grad)


def _schedule(spec, carried, mb_consts, consts, bcast, keep: bool):
    """The forward ticks.  Returns the last stage's outputs (whole rows,
    the stages' as zeros elsewhere) and, with ``keep``, the records
    (tick, input leaves, mb_consts leaves, outputs) of this stage's work."""
    s, me, m, group = spec.s, spec.me, spec.m, spec.group
    rows = carried[0].shape[0] // m
    dt = torch.result_type(*carried) if len(carried) > 1 else carried[0].dtype
    split = lambda ts, i: [t.narrow(0, i * rows, rows) for t in ts]
    like = split(carried, 0)
    numel = sum(t.numel() for t in like)
    perm = [(i, i + 1) for i in range(s - 1)]
    outs: List[List[torch.Tensor]] = [None] * m
    records = []
    buf = None
    for t in range(m + s - 1):
        mb = t - me
        if 0 <= mb < m:
            if me == 0:
                inp = split(carried, mb)
            else:
                inp = _unpack(buf, like)
            row = split(mb_consts, mb)
            if keep:
                inp = [x.detach().requires_grad_(True) for x in inp]
                row = [_leaf(x) for x in row]
            y = list(spec.stage_fn(inp, row, consts, bcast, mb))
            if keep:
                records.append((t, inp, row, y))
            if me == s - 1:
                outs[mb] = [x.detach() for x in y]
            packed = _pack([x.detach() for x in y], dt)
        else:
            packed = torch.zeros(numel, dtype=dt, device=carried[0].device)
        buf = _ppermute(packed, perm, group) if s > 1 else packed
    if me == s - 1:
        whole = _pack([torch.cat([o[i] for o in outs]) for i in range(len(carried))], dt)
    else:
        whole = torch.zeros(numel * m, dtype=dt, device=carried[0].device)
    whole = broadcast_from(whole, s - 1, group) if s > 1 else whole
    return _unpack(whole, carried), records


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *tensors):
        nc, nm, nsc, nb, _ = spec.counts
        cut = [0, nc, nc + nm, nc + nm + nsc, nc + nm + nsc + nb, len(tensors)]
        carried, mb_consts, stage_consts, bcast, params = (
            list(tensors[a:b]) for a, b in zip(cut, cut[1:]))
        leaves = [_leaf(c[spec.me]) for c in stage_consts]
        bleaves = [_leaf(c) for c in bcast]
        pleaves = [_leaf(p) for p in params]
        with torch.enable_grad(), _reading(spec.slots, pleaves):
            outs, records = _schedule(spec, [c.detach() for c in carried], mb_consts,
                                      leaves, bleaves, True)
        ctx.spec, ctx.records = spec, records
        ctx.leaves, ctx.bleaves, ctx.pleaves = leaves, bleaves, pleaves
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        s, me, m, group = spec.s, spec.me, spec.m, spec.group
        nc, nm, nsc, nb, _ = spec.counts
        shapes = ctx.shapes
        rows = shapes[0][0][0] // m
        grads = [torch.zeros(sh, dtype=dt, device=dev) if g is None else g
                 for g, (sh, dt, dev) in zip(grads, shapes[:nc])]
        dt = torch.result_type(*grads) if nc > 1 else grads[0].dtype
        like = [g.narrow(0, 0, rows) for g in grads]
        numel = sum(t.numel() for t in like)
        by_tick = {rec[0]: rec for rec in ctx.records}
        inv = [(i + 1, i) for i in range(s - 1)]
        consts = ctx.leaves + ctx.bleaves + ctx.pleaves
        in_grads = [[None] * m for _ in range(nc)]
        row_grads = [[None] * m for _ in range(nm)]
        recv = torch.zeros(numel, dtype=dt, device=grads[0].device)
        with _reading(spec.slots, ctx.pleaves):
            for t in reversed(range(m + s - 1)):
                mb = t - me
                if 0 <= mb < m:
                    _, inp, row, y = by_tick[t]
                    dy = ([g.narrow(0, mb * rows, rows) for g in grads] if me == s - 1
                          else _unpack(recv, like))
                    pairs = [(a, b) for a, b in zip(y, dy) if a.requires_grad]
                    wrt = [x for x in inp + row + consts if x.requires_grad]
                    if pairs and wrt:
                        torch.autograd.backward([a for a, _ in pairs], [b for _, b in pairs],
                                                inputs=wrt)
                    dx = [x.grad if x.grad is not None else torch.zeros_like(x) for x in inp]
                    for i, g in enumerate(dx):
                        in_grads[i][mb] = g
                    for i, x in enumerate(row):
                        row_grads[i][mb] = x.grad
                    packed = _pack(dx, dt)
                else:
                    packed = torch.zeros(numel, dtype=dt, device=recv.device)
                recv = _ppermute(packed, inv, group) if s > 1 else packed
        out = [None] * len(shapes)
        # the inputs' gradients, whole on every rank: each stage's part summed
        summed = []
        for i in range(nc):
            if ctx.needs_input_grad[1 + i]:
                g = (torch.cat(in_grads[i]) if me == 0
                     else torch.zeros(shapes[i][0], dtype=shapes[i][1], device=shapes[i][2]))
                summed.append((i, g))
        for i in range(nm):
            j = nc + i
            if ctx.needs_input_grad[1 + j]:
                sh, dtp, dev = shapes[j]
                parts = [g if g is not None else torch.zeros((rows, *sh[1:]), dtype=dtp, device=dev)
                         for g in row_grads[i]]
                summed.append((j, torch.cat(parts)))
        for i, leaf in enumerate(ctx.leaves):
            j = nc + nm + i
            if ctx.needs_input_grad[1 + j]:
                sh, dtp, dev = shapes[j]
                g = torch.zeros(sh, dtype=dtp, device=dev)
                if leaf.grad is not None:
                    g[me] = leaf.grad
                summed.append((j, g))
        for i, leaf in enumerate(ctx.bleaves):
            j = nc + nm + nsc + i
            if ctx.needs_input_grad[1 + j]:
                sh, dtp, dev = shapes[j]
                summed.append((j, leaf.grad if leaf.grad is not None
                               else torch.zeros(sh, dtype=dtp, device=dev)))
        for dtp in {g.dtype for _, g in summed}:
            part = [(j, g) for j, g in summed if g.dtype == dtp]
            flat = torch.cat([g.reshape(-1) for _, g in part])
            if s > 1:
                flat = all_reduce(flat, group)
            off = 0
            for j, g in part:
                out[j] = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
        for i, leaf in enumerate(ctx.pleaves):
            out[nc + nm + nsc + nb + i] = leaf.grad
        ctx.records = None
        return (None, *out)


def gpipe(stage_fn: Callable, carried: Sequence[torch.Tensor], group, chunks: int = 0,
          mb_consts: Sequence[torch.Tensor] = (), stage_consts: Sequence[torch.Tensor] = (),
          bcast: Sequence[torch.Tensor] = (), modules=()) -> List[torch.Tensor]:
    """The carried tensors after every stage, whole on every stage (module
    docstring)."""
    carried, mb_consts = list(carried), list(mb_consts)
    stage_consts, bcast = list(stage_consts), list(bcast)
    for t in carried:
        if not t.is_floating_point():
            raise TypeError(f"carried tensors must be float (got {t.dtype}); pass masks and "
                            "indices as mb_consts")
    s = max(group_size(group), 1)
    rows = carried[0].shape[0]
    m_req = chunks or s
    m = math.gcd(m_req, rows)
    if m != m_req:
        logger.warning("pipeline microbatches clamped %d -> %d (per-shard rows %d not "
                       "divisible); pipeline bubble grows accordingly", m_req, m, rows)
    slots = _params(modules)
    params = [m_._parameters[k] for m_, k in slots]
    spec = _Spec(stage_fn, group, m, (len(carried), len(mb_consts), len(stage_consts),
                                      len(bcast), len(params)), slots)
    tensors = carried + mb_consts + stage_consts + bcast + params
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_GPipe.apply(spec, *tensors))
    consts = [c[spec.me] for c in stage_consts]
    return _schedule(spec, carried, mb_consts, consts, bcast, False)[0]
