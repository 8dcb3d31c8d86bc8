"""The BASE mixture-of-experts FFN of a transformer layer.

The JAX package's ``models/moe_ffn.py``: under ``--moe-experts=E`` the FFN
of every ``--moe-freq``-th layer is E experts, one a rank of the model axis
(``parallel/moe.py:base_moe_layer``).  The parameters ``centroids`` (E, D),
``wi`` (E, D, F) and ``wo`` (E, F, D) are fp32 and whole as built; the
trainer cuts them to the rank's expert (``parallel/sharding.py`` MOE_RULES),
which is what the forward takes.  The tokens of the batch are flattened,
padded with zero rows to a multiple of model x E per data shard (the
routing needs E equal chunks of E equal slices), routed, and the gated
expert output is returned without the residual, which the layer adds.
"""

import torch
from torch import nn

from ifseg_torch.parallel.moe import base_moe_layer


class MoEFeedForward(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, plan):
        super().__init__()
        e = plan.moe_experts
        self.plan = plan
        self.centroids = nn.Parameter(torch.zeros(e, embed_dim))
        self.wi = nn.Parameter(torch.zeros(e, embed_dim, ffn_dim))
        self.wo = nn.Parameter(torch.zeros(e, ffn_dim, embed_dim))

    def forward(self, x):
        b, l, d = x.shape
        flat = x.reshape(b * l, d)
        n = flat.shape[0]
        mult = self.plan.mesh.size(self.plan.axis) * self.plan.moe_experts
        n_pad = (-n) % mult
        if n_pad:  # zero rows score 0 everywhere and route harmlessly
            flat = torch.cat([flat, flat.new_zeros(n_pad, d)])
        params = {"centroids": self.centroids, "wi": self.wi, "wo": self.wo}
        out = base_moe_layer(params, flat, self.plan.group, self.plan.moe_assignment)
        # the layer adds its own residual: x + gate * expert(x) minus x, as
        # the JAX package rounds it
        return (out - flat)[:n].reshape(b, l, d)
