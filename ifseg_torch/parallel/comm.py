"""The collectives of the port, and the autograd functions built on them.

Each takes a process group, or None for one process, where it is the
identity.  Sums only: a mean is a sum over a count the caller knows.  A
gather is ``all_gather_into_tensor`` and a reduce-scatter
``reduce_scatter_tensor`` on the dim moved to the front, on NCCL and on
gloo alike: gloo carries both for CUDA tensors as well as for CPU ones
(with all-reduce, broadcast and all-gather; on the H100's machine it
aborts the process on a CUDA send/recv, which no strategy here uses).  No
tensor leaves its device.

The autograd functions are Megatron's four (tensor parallelism over the
'model' group) and the FSDP gather:

- ``copy_to``: identity forward, all-reduce backward (a replicated input
  consumed by a split computation);
- ``reduce_from``: all-reduce forward, identity backward (the partial
  outputs of a row-parallel product);
- ``gather_from``: all-gather forward on a dim, the rank's slice backward (a
  column-parallel output that must become whole again);
- ``all_reduce_both``: all-reduce both ways (a sum over a split dim whose
  result every rank consumes in its own way, the split LayerNorm's row
  statistics);
- ``gather_params``: all-gather forward, reduce-scatter backward (FSDP
  shards made whole for a step), each in one collective over all the
  shards, flattened end to end.
"""

from typing import Iterable, List, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``; returns ``x``."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_reduce_groups(x: torch.Tensor, groups: Iterable) -> torch.Tensor:
    """In-place sum over each group in turn: over their product, where the
    groups are dims of one mesh."""
    for g in groups:
        all_reduce(x, g)
    return x


def all_gather_many(xs: Sequence[torch.Tensor], dims: Sequence[int], group) -> List[torch.Tensor]:
    """For each ``xs[i]``, the ranks' equal slices on ``dims[i]`` concatenated
    in rank order: one all-gather of all of them flattened (one dtype)."""
    if group is None:
        return list(xs)
    n = group_size(group)
    moved = [x.movedim(d % x.dim(), 0).contiguous() for x, d in zip(xs, dims)]
    flat = torch.cat([m.reshape(-1) for m in moved])
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    out = out.view(n, -1)
    whole, offset = [], 0
    for m, d in zip(moved, dims):
        k = m.numel()
        piece = out[:, offset:offset + k].reshape(n * m.shape[0], *m.shape[1:])
        whole.append(piece.movedim(0, d % m.dim()).contiguous().clone())
        offset += k
    return whole


def reduce_scatter_many(xs: Sequence[torch.Tensor], dims: Sequence[int],
                        group) -> List[torch.Tensor]:
    """For each ``xs[i]``, its sum over ``group``, this rank's equal slice on
    ``dims[i]``: one reduce-scatter of all of them flattened."""
    if group is None:
        return list(xs)
    n = group_size(group)
    moved = [x.movedim(d % x.dim(), 0).contiguous() for x, d in zip(xs, dims)]
    # row r: every tensor's slice r, flattened and laid end to end
    flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
    out = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
    dist.reduce_scatter_tensor(out, flat.reshape(-1), group=group)
    parts, offset = [], 0
    for m, d in zip(moved, dims):
        k = m.numel() // n
        part = out[offset:offset + k].reshape(m.shape[0] // n, *m.shape[1:])
        parts.append(part.movedim(0, d % m.dim()).contiguous())
        offset += k
    return parts


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' equal slices on ``dim``, concatenated in rank order."""
    return all_gather_many([x], [dim], group)[0]


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, this rank's equal slice on ``dim``."""
    return reduce_scatter_many([x], [dim], group)[0]


def all_gather_scalars(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order."""
    if group is None:
        return x[None]
    return all_gather_dim(x[None], 0, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        part = g.narrow(ctx.dim, group_rank(ctx.group) * ctx.size, ctx.size)
        return part.contiguous(), None, None


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dims, group, *shards):
        ctx.dims, ctx.group = dims, group
        ctx.shapes = [(s.shape, s.dtype, s.device) for s in shards]
        whole = all_gather_many(shards, dims, group)
        ctx.whole_shapes = [w.shape for w in whole]
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
                 for g, shape, (_, dt, dev) in zip(grads, ctx.whole_shapes, ctx.shapes)]
        return (None, None, *reduce_scatter_many(grads, ctx.dims, ctx.group))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def all_reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceBoth.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim % x.dim(), group)


def gather_params(shards: Sequence[torch.Tensor], dims: Sequence[int], group,
                  grad: bool = True) -> List[torch.Tensor]:
    """The whole tensors of FSDP shards, in one all-gather: with ``grad``,
    the gradients that reach them are summed over the group and each shard
    takes its slice, in one reduce-scatter when the backward has reached
    them all."""
    if group is None or not shards:
        return list(shards)
    if grad and torch.is_grad_enabled():
        return list(_GatherParams.apply(list(dims), group, *shards))
    return all_gather_many([s.detach() for s in shards], dims, group)


def max_across(value: int, group) -> int:
    """The largest ``value`` over the ranks of ``group`` (a host group: the
    value travels as a CPU tensor)."""
    if group is None:
        return value
    t = torch.tensor([float(value)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())
