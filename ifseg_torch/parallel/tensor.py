"""Tensor parallelism of SegOFA over the mesh's 'model' group (Megatron's
column and row splits, written with explicit collectives).

``apply_tensor_parallel`` cuts every parameter that ``TP_RULES`` splits to
this rank's part and gives the modules that use them their parallel
classes:

- q/k/v and fc1 (``ColumnParallelLinear``): the input enters through
  ``copy_to``, the output is this rank's columns (its heads, its slice of
  the FFN width);
- out_proj and fc2 (``RowParallelLinear``): the partial products are
  summed over the group (``reduce_from``), then the bias is added once;
- the token embedding (``VocabParallelEmbedding``): each rank looks up the
  ids of its rows of the vocabulary, zeros elsewhere, and the group sums;
- image_proj (``GatheredColumnLinear``): column-parallel, then the output
  is gathered whole again (the JAX package splits its kernel's output);
- the FFN LayerNorm, which normalises the split FFN width
  (``SplitLayerNorm``): where a gradient flows, the row statistics are
  summed over the group and its weight and bias, whole on every rank as in
  the JAX package, enter by their slices; without one (the monitoring
  forward, evaluation) the rows are gathered whole and normalised by the
  one-pass kernel (``fused_layer_norm``), as GSPMD replicates the input of
  the JAX package's Pallas LayerNorm, and each rank keeps its slice.

Each attention then runs on its H/tp heads: ``num_heads`` becomes the local
count, the per-head gains ``c_attn`` and the bias tables are used by their
head slices (``TensorParallel.part``), and the encoder and decoder build the
rank's bias packs (layers, H/tp, Lq, Lk) directly from those slices, so the
attention kernels get a contiguous row-padded pack of the local heads.  A
tensor whole on every rank and used by its slice (a head scale, a bias
table, a position projection's output, the prefix key/values) enters
through ``copy_to`` and is cut: its gradient is summed over the group, so
every rank holds the whole gradient of a whole parameter.

Activations outside the split regions are the same on every rank of the
group, so the ranks of a group share the dropout generator: a mask on them
is drawn alike everywhere.  Dropout inside a split region (attention
probabilities, the FFN activation) draws from the same generator on a
tensor of the same local shape on every rank, so the ranks' streams stay
together and their masks repeat across the group's head slices.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ifseg_torch.models.attention import Linear, MultiheadAttention
from ifseg_torch.models.layers import FeedForward, LayerNorm
from ifseg_torch.ops.layer_norm import fused_layer_norm
from .comm import all_reduce_both, copy_to, gather_from, group_rank, group_size, reduce_from
from .sharding import tp_dim


class TensorParallel:
    """The 'model' group as the modules see it."""

    def __init__(self, group):
        self.group = group
        self.size = group_size(group)
        self.rank = group_rank(group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_from(x, dim, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_both(x, self.group)

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice on ``dim`` of a tensor that is whole on every
        rank; its gradient is summed over the group."""
        n = x.shape[dim] // self.size
        return copy_to(x, self.group).narrow(dim, self.rank * n, n)


class ColumnParallelLinear(Linear):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(self.tp.enter(x), self.weight.to(x.dtype), bias)


class GatheredColumnLinear(Linear):
    """Column-parallel on a weight split on its output, with a bias that is
    whole on every rank; the output gathered whole."""

    def forward(self, x):
        bias = None if self.bias is None else self.tp.part(self.bias, 0).to(x.dtype)
        y = F.linear(self.tp.enter(x), self.weight.to(x.dtype), bias)
        return self.tp.gather(y, -1)


class RowParallelLinear(Linear):
    def forward(self, x):
        y = self.tp.reduce(F.linear(x, self.weight.to(x.dtype)))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class VocabParallelEmbedding(nn.Embedding):
    """Rows [rank * V/tp, (rank + 1) * V/tp) of the table on each rank."""

    def forward(self, ids):
        rows = self.weight.shape[0]
        lo = self.tp.rank * rows
        inside = (ids >= lo) & (ids < lo + rows)
        out = F.embedding((ids - lo).clamp(0, rows - 1), self.weight)
        return self.tp.reduce(out * inside[..., None].to(out.dtype))


class SplitLayerNorm(LayerNorm):
    """LayerNorm over a width split across the group.  With a gradient the
    row sums (and the sums of squared deviations) are summed over the group
    and the variance is E[(x - E[x])²], as ``F.layer_norm`` takes it;
    without one the rows are gathered whole, ``fused_layer_norm`` (the
    one-pass kernel on a CUDA tensor) normalises them, and the rank keeps
    its slice of the output."""

    def forward(self, x, out_dtype=torch.float32):
        tp = self.tp
        n = x.shape[-1]
        w, b = self.weight, self.bias
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
            w, b = tp.part(w, 0), tp.part(b, 0)
            x32 = x.float()
            mean = tp.sum(x32.sum(-1, keepdim=True)) / (n * tp.size)
            d = x32 - mean
            var = tp.sum((d * d).sum(-1, keepdim=True)) / (n * tp.size)
            y = d * torch.rsqrt(var + self.eps) * w + b
            return y.to(out_dtype)
        y = fused_layer_norm(tp.gather(x, -1), w, b, self.eps, out_dtype)
        return y.narrow(-1, tp.rank * n, n)


_CLASSES = {0: ColumnParallelLinear, 1: RowParallelLinear}


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, group) -> TensorParallel:
    """Cut ``model`` (whole, as built or loaded) to this rank's part of the
    'model' group ``group`` and wire its modules (module docstring).  With
    a group of one rank the wiring runs and every cut is whole."""
    tp = TensorParallel(group)
    mods = dict(model.named_modules())
    done = set()
    for name, p in list(model.named_parameters()):
        mname, _, pname = name.rpartition(".")
        mod = mods[mname]
        dim = tp_dim(name, p.shape, tp.size)
        if dim is None:
            continue
        n = p.shape[dim] // tp.size
        part = p.detach().narrow(dim, tp.rank * n, n).clone()
        setattr(mod, pname, nn.Parameter(part, requires_grad=p.requires_grad))
        if id(mod) in done:
            continue
        done.add(id(mod))
        if isinstance(mod, nn.Embedding):
            mod.__class__ = VocabParallelEmbedding
        elif mname.endswith("image_proj"):
            mod.__class__ = GatheredColumnLinear
        else:
            mod.__class__ = _CLASSES[dim if pname == "weight" else 0]
        mod.tp = tp
    for mod in model.modules():
        if isinstance(mod, MultiheadAttention):
            if mod.num_heads % tp.size:
                raise ValueError(f"{mod.num_heads} heads do not split over {tp.size} ranks")
            mod.num_heads //= tp.size
            mod.tp = tp
        elif isinstance(mod, FeedForward) and mod.ffn_layernorm is not None:
            mod.ffn_layernorm.__class__ = SplitLayerNorm
            mod.ffn_layernorm.tp = tp
    model.encoder.tp = tp
    model.decoder.tp = tp
    return tp
