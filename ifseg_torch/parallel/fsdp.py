"""Fully sharded data parallelism (ZeRO-3) over the mesh's 'fsdp' group,
written with explicit collectives: each unit of the model is whole only
while it computes, as in torch's FSDP2 and in the JAX package's GSPMD step.

``FullyShardedParams`` cuts every parameter that the sharding rules split
over 'fsdp' to this rank's part, in place: between steps the model holds
only its shards, and so do its gradients, the optimizer's state and the
EMA copy.  The split parameters fall into units, each parameter into one:

  - each encoder and each decoder layer (``{encoder,decoder}.layers.{i}``),
    gathered by ``models/layers.py:run_layer`` around the layer;
  - the token embedding that the encoder and the decoder share
    (``encoder.embed_tokens``) and the ResNet stem (``encoder.embed_images``),
    gathered by hooks on their modules around each call of their forward: a
    lookup saves no weight for the backward, and the stem's convolutions
    save their BN-folded weights, not the gathered ones, so neither keeps
    its whole tensors past the call (a frozen stem, whose folded weights
    the trainer caches whole, gathers nothing in its forward);
  - the root: every other split parameter (the position embeddings and
    their projections, the per-layer relative-position tables that the
    bias packs read all at once, ``image_proj``, the seg head, the prompt
    encoders), gathered by the trainer around each forward and whole
    through the step, as FSDP2's root is.  Under the pipeline the layers
    join the root: the stage loop reads its layers' parameters as the
    whole-step gather leaves them.

A use of a unit (``Unit.use``) all-gathers its shards in one collective
(``comm.gather_params``; the frozen ones in another, without a gradient),
sets each whole tensor where its module reads the parameter, and puts the
shards back at the exit.  A layer's linear weights travel in the compute
dtype, as the layer casts them at use anyway (a cast commutes with the
gather bit for bit, and half the bytes travel); the rest in fp32.  Where a
gradient flows, the gather's backward casts the whole gradients to fp32,
sums them over the group and keeps this rank's slices, in one
reduce-scatter as soon as the unit's backward is done, so a shard's
``.grad`` is its part of the group's sum (under ``update_freq`` each
microbatch adds its own).  A unit that computes on every rank joins every
collective on every rank; a parameter of it that the loss does not reach
gets a zero gradient.

After a layer's forward the autograd graph would keep its whole weights
for the backward.  Two routes free them at the exit:

  - under activation checkpointing the gather runs inside the
    checkpointed region, so nothing of it is saved and the recompute
    gathers again (the backward's order, the same on every rank; a
    selective policy saves the attention's outputs, never a weight);
  - without it the layer runs under saved-tensor hooks
    (``torch.autograd.graph.saved_tensors_hooks``) that save a token in
    place of every tensor on a whole weight's storage (the weight or a view
    of it), and the first unpack of one of the unit's tokens in the
    backward gathers the unit again (one all-gather, without a gradient).
    The re-gathered weights stay in one slot until the unit's
    reduce-scatter, or the next unit's re-gather, drops them.

The hooks were chosen over FSDP2's freeing and refilling of the whole
storage because they need no trigger before a unit's backward (its first
unpack is one), and they free the weights of a frozen unit too (prompt
tuning, BitFit), which no reduce-scatter of its own would free.

So the most whole bytes alive at once are the root's plus those of the
largest other unit (``max_whole_bytes``), where a whole-step gather held
every split parameter.  ``WholeTracker`` counts them as they live, by weak
references to the gathered storages.  Tensors computed from a whole weight
are not tokens, and stay as long as autograd or a cache holds them: a
frozen stem's BN-folded weights (``ResNetStem.fold``, whole on every rank
as they were), and a trainable stem's folded weights until its backward.
"""

import re
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ifseg_torch.models.attention import Linear
from .comm import gather_params, group_rank, group_size

ROOT = "root"
# the units gathered by hooks on their module's forward
HOOKED = ("encoder.embed_tokens", "encoder.embed_images")
_LAYER = re.compile(r"^((?:encoder|decoder)\.layers\.\d+)\.")


def _unit_of(name: str, pipeline: bool = False) -> str:
    """The unit of parameter ``name`` (module docstring)."""
    m = _LAYER.match(name)
    if m and not pipeline:
        return m.group(1)
    return next((u for u in HOOKED if name.startswith(u + ".")), ROOT)


class WholeTracker:
    """The whole bytes that the gathers made and that are still alive, by
    unit, and the most alive at once since ``reset_peak``."""

    def __init__(self):
        self.alive: Dict[str, int] = {}
        self.reset_peak()

    def add(self, unit: str, tensors) -> None:
        for t in tensors:
            n = t.numel() * t.element_size()
            if not n:
                continue
            self.alive[unit] = self.alive.get(unit, 0) + n
            weakref.finalize(t.untyped_storage(), self._free, unit, n)
        self._note()

    def _free(self, unit: str, n: int) -> None:
        self.alive[unit] -= n
        if not self.alive[unit]:
            del self.alive[unit]

    def _note(self) -> None:
        self.peak_bytes = max(self.peak_bytes, sum(self.alive.values()))
        self.peak_units = max(self.peak_units, sum(u != ROOT for u in self.alive))

    def reset_peak(self) -> None:
        self.peak_bytes = 0
        self.peak_units = 0  # the most units other than the root alive at once
        self._note()


class _Token:
    """What a saved tensor on a whole weight's storage is saved as."""
    __slots__ = ("use", "index", "shape", "stride", "offset")

    def __init__(self, use, index, shape, stride, offset):
        self.use, self.index = use, index
        self.shape, self.stride, self.offset = shape, stride, offset


class _Use:
    """One use of a unit: the shards it gathered, for its tokens."""

    def __init__(self, unit: "Unit", shards):
        self.unit, self.shards = unit, shards

    def done(self) -> None:
        """The unit's reduce-scatter comes next: drop its re-gathered weights."""
        self.unit.owner.drop(self)

    def hooks(self, whole):
        ptrs = {(w.device, w.untyped_storage().data_ptr()): i
                for i, w in enumerate(whole) if w.numel()}
        dtypes = [w.dtype for w in whole]

        def pack(t):
            if t.layout == torch.strided and t.numel():
                i = ptrs.get((t.device, t.untyped_storage().data_ptr()))
                if i is not None and t.dtype == dtypes[i]:
                    return _Token(self, i, tuple(t.shape), t.stride(), t.storage_offset())
            return t

        def unpack(x):
            if isinstance(x, _Token):
                whole = x.use.unit.owner.refill(x.use)
                return whole[x.index].as_strided(x.shape, x.stride, x.offset)
            return x

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


class Unit:
    """Parameters gathered together: ``entries`` are (module, parameter
    name, split dim, dtype the shard travels in or None for its own)."""

    def __init__(self, name: str, entries, owner: "FullyShardedParams"):
        self.name, self.entries, self.owner = name, entries, owner
        n = group_size(owner.group)
        self.bytes = sum(mod._parameters[p].numel() * n
                         * (dt or mod._parameters[p].dtype).itemsize
                         for mod, p, _, dt in entries)

    def gather(self, shards, on_backward=None) -> List[torch.Tensor]:
        """The whole tensors of ``shards`` (in entry order): one all-gather
        for those that take a gradient, one for the rest, by dtype."""
        grad = torch.is_grad_enabled()
        keys = [(grad and s.requires_grad, dt) for s, (_, _, _, dt) in zip(shards, self.entries)]
        whole: List[Optional[torch.Tensor]] = [None] * len(shards)
        for key in dict.fromkeys(keys):
            idx = [i for i, k in enumerate(keys) if k == key]
            got = gather_params([shards[i] for i in idx], [self.entries[i][2] for i in idx],
                                self.owner.group, key[1], on_backward if key[0] else None)
            for i, w in zip(idx, got):
                whole[i] = w
        # (over no group a shard that needs no cast is its own whole tensor)
        self.owner.tracker.add(self.name, [w for w, s in zip(whole, shards) if w is not s])
        return whole

    @contextmanager
    def use(self, tokens: bool = False):
        """The whole parameters in place of the shards for the block (a
        collective over the group).  ``tokens``: where a gradient flows,
        what the block saves of them is a token, gathered again in the
        backward (module docstring)."""
        shards = [mod._parameters[p] for mod, p, _, _ in self.entries]
        state = _Use(self, shards)
        whole = self.gather(shards, state.done)
        try:
            for (mod, p, _, _), w in zip(self.entries, whole):
                mod._parameters[p] = w  # a plain tensor where the module reads its parameter
            if tokens and torch.is_grad_enabled():
                with state.hooks(whole):
                    yield
            else:
                yield
        finally:
            for (mod, p, _, _), s in zip(self.entries, shards):
                mod._parameters[p] = s


def _folded(stem: nn.Module) -> bool:
    """Whether every convolution of ``stem`` has its BN-folded weights
    cached (``ResNetStem.fold``), so that its forward reads no parameter."""
    return all(getattr(m, "folded", None) is not None
               for m in stem.modules() if isinstance(m, nn.Conv2d))


def _hook_forward(module: nn.Module, unit: Unit, skip=lambda mod: False) -> None:
    """Gather ``unit`` around every call of ``module``'s forward where
    ``skip(module)`` is false."""
    open_uses = []

    def pre(mod, args):
        use = None if skip(mod) else unit.use()
        if use is not None:
            use.__enter__()
        open_uses.append(use)

    def post(mod, args, out):
        use = open_uses.pop()
        if use is not None:
            use.__exit__(None, None, None)

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post, always_call=True)


class FullyShardedParams:
    def __init__(self, model: nn.Module, dims: Dict[str, int], group,
                 compute_dtype: torch.dtype = torch.float32, pipeline: bool = False):
        """``dims``: parameter name -> the dim split over ``group``.  A
        layer's linear weights travel in ``compute_dtype``; ``pipeline``: the
        layers join the root."""
        self.group = group
        self.tracker = WholeTracker()
        self._slot: Optional[Tuple[_Use, List[torch.Tensor]]] = None
        mods = dict(model.named_modules())
        n, r = group_size(group), group_rank(group)
        by_unit: Dict[str, list] = {}
        with torch.no_grad():
            for name, p in list(model.named_parameters()):
                if name not in dims:
                    continue
                mname, _, pname = name.rpartition(".")
                mod, dim = mods[mname], dims[name]
                size = p.shape[dim] // n
                part = p.detach().narrow(dim, r * size, size).clone()
                setattr(mod, pname, nn.Parameter(part, requires_grad=p.requires_grad))
                unit = _unit_of(name, pipeline)
                layer = unit not in (ROOT, *HOOKED)
                cast = compute_dtype if layer and isinstance(mod, Linear) else None
                by_unit.setdefault(unit, []).append((mod, pname, dim, cast))
        self.units: Dict[str, Unit] = {u: Unit(u, e, self) for u, e in by_unit.items()}
        self.root = self.units.get(ROOT) or Unit(ROOT, [], self)
        for name, unit in self.units.items():
            if name == "encoder.embed_images":
                _hook_forward(mods[name], unit, skip=_folded)
            elif name in HOOKED:
                _hook_forward(mods[name], unit)
            elif name != ROOT:
                mods[name].fsdp_unit = unit

    def max_whole_bytes(self) -> int:
        """The most whole bytes the units can hold at once: the root's and
        the largest other unit's."""
        others = [u.bytes for name, u in self.units.items() if name != ROOT]
        return self.root.bytes + max(others, default=0)

    def refill(self, use: _Use) -> List[torch.Tensor]:
        """``use``'s whole tensors again, for its tokens: gathered at the
        first unpack, in place of the last unit's (one slot)."""
        if self._slot is None or self._slot[0] is not use:
            self._slot = None
            with torch.no_grad():
                self._slot = (use, use.unit.gather(use.shards))
        return self._slot[1]

    def drop(self, use: Optional[_Use] = None) -> None:
        """Drop the re-gathered tensors (``use``'s only, where given)."""
        if self._slot is not None and (use is None or self._slot[0] is use):
            self._slot = None
