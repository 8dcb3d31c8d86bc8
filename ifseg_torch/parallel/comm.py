"""The collectives of the port, and the autograd functions built on them.

Each takes a process group, or None for one process, where it is the
identity.  Sums only: a mean is a sum over a count the caller knows.  A
gather is ``all_gather_into_tensor`` of the inputs flattened end to end,
each whole tensor then one concatenation of the ranks' slices on its dim;
a reduce-scatter is ``reduce_scatter_tensor`` of each tensor's slices laid
out rank by rank; on NCCL and on gloo alike: gloo carries both for CUDA
tensors as well as for CPU ones
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
- ``gather_params``: all-gather forward, reduce-scatter backward (the
  shards of an FSDP unit made whole where the unit computes, the experts'
  centroids), each in one collective over all the shards, flattened end
  to end.

The model axis's programs (the GPipe pipeline, ring attention, the BASE
mixture of experts) add:

- ``slice_to``: the rank's slice forward, all-gather backward (the other
  half of Megatron's pair with ``gather_from``: a replicated tensor whose
  rows are split across the group, each rank's gradient rows made whole
  on every rank);
- ``ppermute(x, perm, group)``: rank ``src`` sends ``x`` to rank ``dst`` for
  each ``(src, dst)`` of ``perm``; a rank no pair sends to receives zeros.
  Backward: the inverse permutation;
- ``all_to_all(x, group)``: ``x`` of n equal chunks on dim 0, chunk i to
  rank i; out chunk j came from rank j.  Backward: the same exchange.

Their routes: an all-to-all is ``all_to_all_single`` on both backends
(gloo carries it for CUDA tensors on the H100's machine, probed there in a
child process pair).  A ppermute (``PPERMUTE_ROUTE``) is ``batch_isend_irecv``
on NCCL; gloo aborts the process on a send/recv of a CUDA tensor, so there
it is an all-gather from which each rank takes its source's part (n times
the bytes).  Every tensor stays on its device.

``TRAFFIC`` counts, by collective, the calls, the bytes each rank hands
to it (its input's bytes) and the host seconds spent in it (gloo, and a
blocking send/recv, return when the exchange is done; an NCCL collective
when it is queued), for the measurements; ``reset_traffic`` sets it to 0.
"""

import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a ppermute's route on each backend (module docstring)
PPERMUTE_ROUTE = {"nccl": "send_recv", "gloo": "all_gather"}

# collective -> [calls, bytes handed to it by this rank, host seconds in it]
TRAFFIC: Dict[str, list] = defaultdict(lambda: [0, 0, 0.0])


def reset_traffic() -> None:
    TRAFFIC.clear()


def _count(name: str, t0: float, x: torch.Tensor) -> None:
    entry = TRAFFIC[name]
    entry[0] += 1
    entry[1] += x.numel() * x.element_size()
    entry[2] += time.perf_counter() - t0


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``; returns ``x``."""
    if group is not None:
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        _count("all_reduce", t0, x)
    return x


def all_reduce_groups(x: torch.Tensor, groups: Iterable) -> torch.Tensor:
    """In-place sum over each group in turn: over their product, where the
    groups are dims of one mesh."""
    for g in groups:
        all_reduce(x, g)
    return x


def _flatten(xs: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``xs`` flattened end to end in ``dtype``: one copy (a cast where the
    dtype differs), or the tensor itself where it is one of that dtype."""
    if all(x.dtype == dtype for x in xs):
        return xs[0].reshape(-1) if len(xs) == 1 else torch.cat([x.reshape(-1) for x in xs])
    flat = torch.empty(sum(x.numel() for x in xs), dtype=dtype, device=xs[0].device)
    offset = 0
    for x in xs:
        flat[offset:offset + x.numel()].view(x.shape).copy_(x)
        offset += x.numel()
    return flat


def all_gather_many(xs: Sequence[torch.Tensor], dims: Sequence[int], group,
                    dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """For each ``xs[i]``, the ranks' equal slices on ``dims[i]`` concatenated
    in rank order: one all-gather of all of them flattened (in ``dtype``,
    else their one dtype), then one concatenation a tensor."""
    if group is None:
        return [x if dtype is None else x.to(dtype) for x in xs]
    n = group_size(group)
    flat = _flatten(xs, dtype or xs[0].dtype)
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    t0 = time.perf_counter()
    dist.all_gather_into_tensor(out, flat, group=group)
    _count("all_gather", t0, flat)
    rows = out.view(n, -1)
    whole, offset = [], 0
    for x, d in zip(xs, dims):
        k = x.numel()
        whole.append(torch.cat([rows[r, offset:offset + k].view(x.shape) for r in range(n)],
                               dim=d % x.dim()))
        offset += k
    return whole


def reduce_scatter_many(xs: Sequence[torch.Tensor], dims: Sequence[int], group,
                        dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """For each ``xs[i]``, its sum over ``group``, this rank's equal slice on
    ``dims[i]`` (a view of one buffer): one reduce-scatter of all of them
    laid out rank by rank in ``dtype`` (else their one dtype), each
    tensor's slices written there by one copy (and cast)."""
    if group is None:
        return [x if dtype is None else x.to(dtype) for x in xs]
    n = group_size(group)
    shapes = []
    for x, d in zip(xs, dims):
        d = d % x.dim()
        shapes.append((d, x.shape[:d] + (x.shape[d] // n,) + x.shape[d + 1:]))
    total = sum(x.numel() for x in xs) // n
    # row r: every tensor's slice r, flattened and laid end to end
    flat = torch.empty(n, total, dtype=dtype or xs[0].dtype, device=xs[0].device)
    offset = 0
    for x, (d, shape) in zip(xs, shapes):
        k = x.numel() // n
        flat[:, offset:offset + k].view(n, *shape).copy_(
            x.unflatten(d, (n, shape[d])).movedim(d, 0))
        offset += k
    out = torch.empty(total, dtype=flat.dtype, device=flat.device)
    t0 = time.perf_counter()
    dist.reduce_scatter_tensor(out, flat.view(-1), group=group)
    _count("reduce_scatter", t0, flat)
    parts, offset = [], 0
    for x, (_, shape) in zip(xs, shapes):
        k = x.numel() // n
        parts.append(out[offset:offset + k].view(shape))
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
    def forward(ctx, dims, group, dtype, on_backward, *shards):
        ctx.dims, ctx.group, ctx.on_backward = dims, group, on_backward
        ctx.dtype, ctx.device = shards[0].dtype, shards[0].device
        whole = all_gather_many(shards, dims, group, dtype)
        ctx.whole_shapes = [w.shape for w in whole]
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.on_backward is not None:
            ctx.on_backward()
        zero = torch.zeros((), dtype=ctx.dtype, device=ctx.device)
        grads = [zero.expand(shape) if g is None else g
                 for g, shape in zip(grads, ctx.whole_shapes)]
        # cast back to the shards' dtype in the reduce-scatter's own copy
        return (None, None, None, None,
                *reduce_scatter_many(grads, ctx.dims, ctx.group, ctx.dtype))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def all_reduce_both(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceBoth.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim % x.dim(), group)


def gather_params(shards: Sequence[torch.Tensor], dims: Sequence[int], group,
                  dtype: Optional[torch.dtype] = None,
                  on_backward: Optional[Callable[[], None]] = None) -> List[torch.Tensor]:
    """The whole tensors of sharded parameters, in one all-gather (each
    shard cast to ``dtype`` first where one is given: a cast commutes with
    the gather, and half the bytes travel).  Where a gradient flows, the
    gradients that reach them are cast back to the shards' dtype (zeros
    for one that none reaches), summed over the group and cut to each
    shard's slice in one reduce-scatter, when the backward has reached
    them all; ``on_backward`` is called just before it."""
    if group is None or not shards:
        return [s if dtype is None else s.to(dtype) for s in shards]
    if torch.is_grad_enabled() and any(s.requires_grad for s in shards):
        return list(_GatherParams.apply(list(dims), group, dtype, on_backward, *shards))
    return all_gather_many([s.detach() for s in shards], dims, group, dtype)


def _ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """The exchange of ``ppermute``, without autograd (see the module
    docstring for the routes)."""
    n, me = group_size(group), group_rank(group)
    src = {d: s for s, d in perm}
    dst = {s: d for s, d in perm}
    x = x.contiguous()
    if PPERMUTE_ROUTE[dist.get_backend(group)] == "send_recv":
        out = torch.zeros_like(x)
        ops = []
        if me in dst:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst[me]), group))
        if me in src:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src[me]), group))
        t0 = time.perf_counter()
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        _count("ppermute", t0, x)
        return out
    every = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    t0 = time.perf_counter()
    dist.all_gather_into_tensor(every, x.reshape(-1), group=group)
    _count("ppermute", t0, x)
    return every.view(n, *x.shape)[src[me]].clone() if me in src else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, [(d, s) for s, d in ctx.perm], ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """``jax.lax.ppermute`` over ``group``: for each (src, dst) of ``perm``
    rank ``dst`` gets rank ``src``'s ``x``; a rank no pair names as its
    destination gets zeros.  Differentiable: the backward sends the
    gradients by the inverse permutation."""
    if group is None:
        return x
    perm = [(int(s), int(d)) for s, d in perm]
    return _PPermute.apply(x, perm, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    n = group_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all of {x.shape[0]} chunks over {n} ranks")
    out = torch.empty_like(x)
    t0 = time.perf_counter()
    dist.all_to_all_single(out, x, group=group)
    _count("all_to_all", t0, x)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``:
    ``x`` holds one equal chunk per rank on dim 0; chunk i goes to rank i,
    and chunk j of the result came from rank j.  Differentiable (the
    backward is the same exchange)."""
    return x if group is None else _AllToAll.apply(x, group)


class _SliceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // group_size(group)
        return x.narrow(dim, group_rank(group) * n, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


def slice_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal slice of ``x`` on ``dim`` (``x`` the same on every
    rank); the backward gathers the ranks' slices of the gradient, so every
    rank gets the whole gradient of ``x``."""
    if group is None:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % group_size(group):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{group_size(group)} ranks")
    return _SliceTo.apply(x, dim, group)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``x`` (group rank) on every rank of ``group``, in place
    of ``x`` (no autograd)."""
    if group is None:
        return x
    x = x.contiguous()
    t0 = time.perf_counter()
    dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    _count("broadcast", t0, x)
    return x


def max_across(value, group):
    """The largest ``value`` (an int or a float, returned as such) over the
    ranks of ``group`` (a host group: the value travels as a CPU tensor)."""
    if group is None:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return type(value)(t.item())
