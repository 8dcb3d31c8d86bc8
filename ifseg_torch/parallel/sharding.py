"""Which dims of each parameter (and of its optimizer state) are split over
which mesh dim: the JAX package's sharding rules on the port's names.

Rules (the JAX package's ``parallel/sharding.py``, GSPMD there):

  TP   — Megatron column/row splits over 'model': q/k/v and fc1 split on
         their outputs, out_proj and fc2 on their inputs, the token
         embedding on the vocabulary, image_proj on its output.  A flax
         kernel is (in, out) and a torch weight (out, in), so the JAX
         package's ``P(None, "model")`` on ``q_proj/kernel`` is dim 0 of the
         torch weight here, and ``P("model", None)`` on ``out_proj/kernel``
         dim 1.
  FSDP — parameters of two dims or more also split over 'fsdp' on the
         largest dim that is not split yet and divides evenly (at least 8
         a rank); an embedding table only on its rows.
  MoE  — the BASE experts (``layers.N.moe.{centroids,wi,wo}``, stacked
         (E, ...)) split over 'model' on the expert dim, one expert a rank,
         whatever holds the other parameters (``shardings_for_plan``).
  ZeRO-1 — the optimizer state also split over 'data' the same way, the
         parameters staying whole.

"Largest" is decided on the JAX package's view of the parameter (its
``jax_paths`` layout: transposed kernels, HWIO convolutions, one stacked
array for each side's per-layer relative-position tables), so a tie goes
the way it goes there.  A split the JAX package puts on the stacked layer
dim of those tables has no per-table counterpart and stays whole here.

A layout is ``{torch dim: mesh dim name}``.  ``local_part`` cuts a whole
tensor to this rank's part of a layout, ``gather_whole`` puts the parts
back together (a collective: every rank of the groups calls it).
"""

import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ifseg_torch.train.optim import jax_paths
from .comm import all_gather_dim
from .mesh import ProcessMesh

# (regex on the port's parameter name, the torch dim split over 'model')
TP_RULES: List[Tuple[str, int]] = [
    # attention: column-parallel q/k/v (weight and bias), row-parallel out
    (r"layers\.\d+\.(self_attn|encoder_attn)\.(q_proj|k_proj|v_proj)\.(weight|bias)$", 0),
    (r"layers\.\d+\.(self_attn|encoder_attn)\.out_proj\.weight$", 1),
    # FFN: column fc1, row fc2
    (r"layers\.\d+\.fc1\.(weight|bias)$", 0),
    (r"layers\.\d+\.fc2\.weight$", 1),
    # the token embedding on its vocabulary, image_proj on its output
    (r"(^|\.)embed_tokens\.weight$", 0),
    (r"(^|\.)image_proj\.weight$", 0),
]

# the BASE experts: one expert a rank of the 'model' dim
MOE_RULES: List[Tuple[str, int]] = [
    (r"\.moe\.(centroids|wi|wo)$", 0),
]


def shardings_for_plan(dist_cfg, tp: Optional[bool] = None) -> List[Tuple[str, int]]:
    """The rules that place parameters on the 'model' dim for a distributed
    config (the JAX package's ``shardings_for_plan``): TP's only where tensor
    parallelism holds that dim (above degree 1, or as ``tp`` says), the
    experts' wherever there are experts; a pipeline or ring keeps every
    other parameter whole there."""
    if tp is None:
        tp = max(getattr(dist_cfg, "tensor_parallel", 1), 1) > 1
    rules = list(TP_RULES) if tp else []
    if max(getattr(dist_cfg, "moe_experts", 0), 0) > 1:
        rules += MOE_RULES
    return rules


# view dim -> torch dim, by jax_paths layout (None: the stacked layer dim)
_CONV = (2, 3, 1, 0)


def _view_to_torch(layout: str, ndim: int) -> List[Optional[int]]:
    if layout == "linear":
        return [1, 0]
    if layout == "conv":
        return list(_CONV)
    if layout == "stacked":
        return [None] + list(range(ndim))
    return list(range(ndim))


def tp_dim(name: str, shape, model: int, rules=TP_RULES) -> Optional[int]:
    """The torch dim of ``name`` split over a 'model' dim of size
    ``model`` by the first of ``rules`` that matches, or None."""
    for pat, dim in rules:
        if re.search(pat, name):
            return dim if dim < len(shape) and shape[dim] % model == 0 else None
    return None


def param_layout(name: str, shape, path: str, layout: str, n_stack: int, mesh_shape: Dict[str, int],
                 axes=("model", "fsdp"), model_rules=TP_RULES) -> Dict[int, str]:
    """``{torch dim: mesh dim}`` of one parameter, as the JAX package's
    ``_spec_for`` places its leaf over the mesh dims ``axes`` ("model" by
    ``model_rules``, TP's by default or ``shardings_for_plan``'s; "fsdp";
    "data" for the optimizer state under ZeRO-1, as
    ``opt_state_shardings`` places it).  A dim of size 1 in ``axes`` is
    placed like a larger one (the JAX package leaves it out): its split is
    whole."""
    to_torch = _view_to_torch(layout, len(shape))
    view_shape = [n_stack if t is None else shape[t] for t in to_torch]
    spec: List[Optional[str]] = [None] * len(view_shape)
    if "model" in axes:
        d = tp_dim(name, shape, mesh_shape["model"], model_rules)
        if d is not None:
            spec[to_torch.index(d)] = "model"

    def place(axis: str, order):
        n = mesh_shape[axis]
        for i in order:
            if spec[i] is None and view_shape[i] % n == 0 and view_shape[i] >= n * 8:
                spec[i] = axis
                return

    order = sorted(range(len(view_shape)), key=lambda i: -view_shape[i])
    if "fsdp" in axes and len(view_shape) >= 2:
        place("fsdp", [0] if path.endswith("embedding") else order)
    if "data" in axes:
        place("data", order)
    return {to_torch[i]: axis for i, axis in enumerate(spec)
            if axis is not None and to_torch[i] is not None}


def model_layouts(model: nn.Module, mesh_shape: Dict[str, int],
                  axes=("model", "fsdp"), model_rules=TP_RULES) -> Dict[str, Dict[int, str]]:
    """name -> layout, for every parameter of ``model`` (whole, as built)."""
    paths = jax_paths(model)
    n_stack = Counter(path for path, _ in paths.values())
    out = {}
    for name, p in model.named_parameters():
        path, layout = paths[name]
        out[name] = param_layout(name, tuple(p.shape), path, layout, n_stack[path], mesh_shape,
                                 axes, model_rules)
    return out


def restrict(layout: Dict[int, str], axes) -> Dict[int, str]:
    return {d: a for d, a in layout.items() if a in axes}


def local_part(whole: torch.Tensor, layout: Dict[int, str], mesh: ProcessMesh) -> torch.Tensor:
    """This rank's part of ``whole`` under ``layout`` (a view)."""
    for dim, axis in sorted(layout.items()):
        n = mesh.size(axis)
        size = whole.shape[dim] // n
        whole = whole.narrow(dim, mesh.index(axis) * size, size)
    return whole


def gather_whole(part: torch.Tensor, layout: Dict[int, str], mesh: ProcessMesh) -> torch.Tensor:
    """The whole tensor from every rank's ``part`` (collective)."""
    for dim, axis in sorted(layout.items()):
        part = all_gather_dim(part, dim, mesh.group(axis))
    return part
