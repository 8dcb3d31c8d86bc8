"""Fully sharded data parallelism (ZeRO-3) over the mesh's 'fsdp' group,
written with explicit collectives.

``FullyShardedParams`` cuts every parameter that the sharding rules split
over 'fsdp' to this rank's part, in place: between steps the model holds
only its shards, and so do its gradients, the optimizer's state and the
EMA copy.  ``gathered()`` makes the parameters whole for a forward and its
backward: the shards are all-gathered on their dims, all in one collective
(``comm.gather_params``: the frozen ones apart, without a gradient), and
each whole tensor is set where the module reads its parameter; at the exit
the shards are put back.  With a gradient the gather's backward sums the
whole gradients over the group and keeps this rank's slices (one
reduce-scatter when the backward has reached every gathered tensor), so a
shard's ``.grad`` is its part of the group's sum.

The whole parameters live from the gather to the end of the backward: the
saved inputs of the backward hold them, and the activation-checkpointed
recompute reads them again.  So the step's peak holds one whole copy of the
parameters, where torch's FSDP2 frees a layer's after its use and gathers
again in the backward; between steps each rank keeps 1/fsdp of them.  The
port's optimizers, the per-tensor reductions of Lamb and Adafactor and the
global norm then work shard by shard (``train/optim.py``, ``Sharding``).
"""

from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch
from torch import nn

from .comm import gather_params, group_rank, group_size


class FullyShardedParams:
    def __init__(self, model: nn.Module, dims: Dict[str, int], group):
        """``dims``: parameter name -> the dim split over ``group``."""
        self.group = group
        mods = dict(model.named_modules())
        self.entries: List[Tuple[nn.Module, str, int]] = []
        n, r = group_size(group), group_rank(group)
        with torch.no_grad():
            for name, p in list(model.named_parameters()):
                if name not in dims:
                    continue
                mname, _, pname = name.rpartition(".")
                mod, dim = mods[mname], dims[name]
                size = p.shape[dim] // n
                part = p.detach().narrow(dim, r * size, size).clone()
                setattr(mod, pname, nn.Parameter(part, requires_grad=p.requires_grad))
                self.entries.append((mod, pname, dim))
        self._active = False

    @contextmanager
    def gathered(self, grad: bool = True):
        """The whole parameters in place of the shards for the block (a
        collective over the group on entry, and one in the backward)."""
        if self._active:
            raise RuntimeError("FSDP parameters are already gathered")
        shards = [mod._parameters[pname] for mod, pname, _ in self.entries]
        self._active = True
        try:
            trains = [s.requires_grad and grad for s in shards]
            whole = [None] * len(shards)
            for flag in (True, False):
                idx = [i for i, t in enumerate(trains) if t == flag]
                got = gather_params([shards[i] for i in idx],
                                    [self.entries[i][2] for i in idx], self.group, flag)
                for i, w in zip(idx, got):
                    whole[i] = w
            for (mod, pname, _), w in zip(self.entries, whole):
                # a plain tensor where the module reads its parameter
                mod._parameters[pname] = w
            yield
        finally:
            for (mod, pname, _), shard in zip(self.entries, shards):
                mod._parameters[pname] = shard
            self._active = False
