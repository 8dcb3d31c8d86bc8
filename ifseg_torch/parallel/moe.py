"""Expert parallelism: the BASE mixture-of-experts layer over the model axis.

The JAX package's ``parallel/moe.py`` (reference modules/base_layer.py +
clib/libbase): one expert FFN a rank of the 'model' group, a balanced
token -> expert assignment, the tokens routed by all-to-all, a sigmoid gate
on the expert's output added to the token.

``x`` enters as the rows of this rank's data shard, the same on every rank
of the group.  Each rank takes its 1/E of them (``comm.slice_to``, whose
backward gathers the rows' gradients whole again), gathers the centroids
(``comm.gather_params``: the backward sums each centroid's gradient over
the group and keeps the rank's own), scores its rows against them in fp32,
assigns them (``ops/balanced_assignment.py``: each expert exactly cap =
rows / E of them), sorts them by expert, and sends chunk e to rank e
(``comm.all_to_all``).  Its expert runs on the E·cap rows it received, the
outputs go back by the same exchange, are unsorted and gated, and the
block is made whole on every rank by gathering the ranks' row slices
(``comm.gather_from``: the sum of disjoint slices the JAX package takes,
whose backward keeps each rank's slice).
"""

from typing import Dict

import torch
import torch.nn.functional as F

from ifseg_torch.ops.balanced_assignment import (
    balanced_assignment_auction,
    balanced_assignment_sinkhorn,
)
from .comm import all_to_all, gather_from, gather_params, group_size, slice_to

ASSIGNMENTS = {"sinkhorn": balanced_assignment_sinkhorn, "auction": balanced_assignment_auction}


@torch.no_grad()
def init_moe_params(generator: torch.Generator, num_experts: int, d_model: int,
                    d_ff: int) -> Dict[str, torch.Tensor]:
    """Whole (E, ...) fp32 expert parameters with the JAX initializers'
    scales: centroids and wi N(0, d_model^-0.5), wo N(0, d_ff^-0.5), drawn
    from ``generator`` on its device in that order."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=generator.device) * std

    return {"centroids": normal((num_experts, d_model), d_model ** -0.5),
            "wi": normal((num_experts, d_model, d_ff), d_model ** -0.5),
            "wo": normal((num_experts, d_ff, d_model), d_ff ** -0.5)}


def expert_ffn(wi: torch.Tensor, wo: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One expert, as the JAX package's ``_expert_ffn`` promotes its types:
    fp32 products of x with the fp32 weights, ``jax.nn.gelu``'s default (the
    tanh approximation) between them, the hidden rounded to x's dtype and
    the output too."""
    h = F.gelu(x.float() @ wi.float(), approximate="tanh")
    return (h.to(x.dtype).float() @ wo.float()).to(x.dtype)


def base_moe_layer(params: Dict[str, torch.Tensor], x: torch.Tensor, group,
                   assignment: str = "sinkhorn") -> torch.Tensor:
    """x -> x + sigmoid(score) * expert(x).  ``params``: this rank's expert,
    ``centroids`` (1, D), ``wi`` (1, D, F), ``wo`` (1, F, D); ``x`` (rows, D),
    the same on every rank of ``group`` (the expert axis).  Rows that do not
    split into E slices of E equal chunks raise: a tail no rank takes would
    come back as zeros."""
    n_exp = group_size(group)
    if params["centroids"].shape[0] != 1:
        raise ValueError(f"{params['centroids'].shape[0]} experts on a rank: cut the (E, ...) "
                         "expert tensors to one a rank of the model axis")
    n_rep, d = x.shape
    if n_rep % (n_exp * n_exp):
        raise ValueError(f"{n_rep} resident rows do not split into {n_exp} slices of {n_exp} "
                         "equal chunks; pad the token axis before base_moe_layer")
    n_local = n_rep // n_exp
    cap = n_local // n_exp
    x_l = slice_to(x, 0, group)
    centroids = gather_params([params["centroids"]], [0], group)[0]  # (E, D)
    scores = x_l.float() @ centroids.float().t()
    expert_of = ASSIGNMENTS[assignment](scores)
    order = torch.argsort(expert_of, stable=True)
    routed = all_to_all(x_l[order].reshape(n_exp, cap, d), group)  # rows for this expert
    out = expert_ffn(params["wi"][0], params["wo"][0], routed.reshape(n_exp * cap, d))
    back = all_to_all(out.reshape(n_exp, cap, d), group).reshape(n_local, d)
    expert_out = back[torch.argsort(order)]
    gate = torch.sigmoid(scores.gather(1, expert_of[:, None])[:, 0]).to(x_l.dtype)
    out_l = x_l + gate[:, None] * expert_out
    return gather_from(out_l, 0, group)


def dense_reference(params: Dict[str, torch.Tensor], x: torch.Tensor, n_shards: int,
                    expert_of) -> torch.Tensor:
    """``base_moe_layer`` without the exchange, over whole (E, ...) expert
    tensors: each of ``n_shards`` equal row slices of ``x`` scored, assigned
    by ``expert_of(scores)`` and run through its experts token by token
    group, the loop of the JAX package's own test."""
    out = torch.empty_like(x)
    per = x.shape[0] // n_shards
    for s in range(n_shards):
        xs = x[s * per:(s + 1) * per]
        scores = xs.float() @ params["centroids"].float().t()
        assign = expert_of(scores)
        for e in range(params["centroids"].shape[0]):
            rows = (assign == e).nonzero()[:, 0]
            eo = expert_ffn(params["wi"][e], params["wo"][e], xs[rows])
            gate = torch.sigmoid(scores[rows, e]).to(xs.dtype)
            out[s * per + rows] = xs[rows] + gate[:, None] * eo
    return out
