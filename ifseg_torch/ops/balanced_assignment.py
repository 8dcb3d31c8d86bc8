"""Balanced token -> expert assignment for the BASE mixture of experts.

Two backends behind one API, the JAX package's ``ops/balanced_assignment.py``:
scores (N, E) -> (N,) int64 expert ids, each expert receiving exactly N/E
tokens.

  - ``balanced_assignment_auction``: the exact auction algorithm in host C++
    (``csrc/balanced_assignment.cpp``, built by ``ops/build.py`` at first
    use), on the scores copied to the host, as the JAX package reaches its
    copy through ``pure_callback``; the ids go back to the scores' device.
  - ``balanced_assignment_sinkhorn``: torch ops on the scores' device:
    Sinkhorn normalisation of the fp32 log-scores (rows, then columns,
    ``n_iters`` times), then at most E + 1 rounds of capacity rounding:
    every unassigned token picks its best open expert (the first index on
    a tie, as ``jnp.argmax``), and each expert keeps its top candidates by
    score up to its remaining capacity (ranks by a stable sort, as
    ``jnp.argsort``'s, so equal scores go by token index).
"""

import ctypes

import numpy as np
import torch

from . import build

SOURCE = "balanced_assignment"


def _auction_host(scores: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    scores = np.ascontiguousarray(scores, np.float32)
    n, e = scores.shape
    if n % e:
        raise ValueError(f"tokens {n} not divisible by experts {e}")
    fn = build.load(SOURCE).balanced_assignment
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = np.empty((n,), np.int32)
    fn(scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, e, eps,
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out


def balanced_assignment_auction(scores: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """The exact auction assignment of (N, E) scores (host C++)."""
    ids = _auction_host(scores.detach().float().cpu().numpy(), eps)
    return torch.from_numpy(ids.astype(np.int64)).to(scores.device)


def balanced_assignment_sinkhorn(scores: torch.Tensor, n_iters: int = 8,
                                 temperature: float = 1.0) -> torch.Tensor:
    """Sinkhorn-normalised plan + capacity rounding on the scores' device:
    (N,) expert ids with exactly N/E tokens an expert."""
    n, e = scores.shape
    if n % e:
        raise ValueError(f"tokens {n} not divisible by experts {e}")
    cap = n // e
    lp = scores.detach().float() / temperature
    for _ in range(n_iters):
        lp = lp - torch.logsumexp(lp, dim=1, keepdim=True)
        lp = lp - torch.logsumexp(lp, dim=0, keepdim=True)
    counts = torch.zeros(e, dtype=torch.int64, device=lp.device)
    out = torch.full((n,), -1, dtype=torch.int64, device=lp.device)
    experts = torch.arange(e, device=lp.device)
    neg_inf = torch.tensor(float("-inf"), device=lp.device)
    for _ in range(e + 1):
        unassigned = out < 0
        pref = torch.where((counts < cap)[None, :], lp, neg_inf)
        choice = pref.argmax(dim=1)  # the first index of the maximum
        cand = (experts[:, None] == choice[None, :]) & unassigned[None, :]
        m = torch.where(cand, lp.t(), neg_inf)  # (E, N)
        order = torch.argsort(-m, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        accept = cand & (rank < (cap - counts)[:, None]) & torch.isfinite(m)
        tok_expert = accept.to(torch.uint8).argmax(dim=0)
        out = torch.where(accept.any(dim=0), tok_expert, out)
        counts = counts + accept.sum(dim=1)
    return out
