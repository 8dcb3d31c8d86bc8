"""Search strategies for sequence generation (the JAX package's
``generate/search.py``; reference custom_fairseq/fairseq/search.py:
BeamSearch :91, Sampling :548, DiverseBeamSearch :434,
DiverseSiblingsSearch :618, LengthConstrained :382, PrefixConstrained :491).

Each strategy's ``step(step_idx, lprobs, scores, generator=None) ->
(cand_scores, cand_indices, cand_beams)``, each (bsz, 2·beam) — twice the
beam, so that hypotheses ending in EOS never starve the search:

  lprobs (bsz, beam, V) this step's token log-probabilities;
  scores (bsz, beam) the cumulative scores, or None.

Ties are broken towards the lower flat index, as ``jax.lax.top_k`` breaks
them (``top_k`` below), so the port picks the same candidates.  Only
``Sampling`` draws, from the ``torch.Generator`` it is given.
"""

import torch
import torch.nn.functional as F


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _first_beam_only(step_idx: int, lprobs: torch.Tensor) -> torch.Tensor:
    """Step 0: every beam holds the same prefix, so only the first may
    propose candidates."""
    if step_idx != 0:
        return lprobs
    first = (torch.arange(lprobs.shape[1], device=lprobs.device) == 0)[None, :, None]
    return lprobs.masked_fill(~first, float("-inf"))


class BeamSearch:
    def step(self, step_idx, lprobs, scores, generator=None):
        bsz, beam, v = lprobs.shape
        if scores is not None:
            lprobs = lprobs + scores[:, :, None]
        lprobs = _first_beam_only(step_idx, lprobs)
        cand_scores, flat_idx = top_k(lprobs.reshape(bsz, beam * v), 2 * beam)
        return cand_scores, flat_idx % v, flat_idx // v


class Sampling:
    """Top-k / top-p (nucleus) ancestral sampling (search.py:548-617): one
    token a beam, by the Gumbel trick over the filtered log-probabilities."""

    def __init__(self, sampling_topk: int = -1, sampling_topp: float = -1.0):
        self.topk = sampling_topk
        self.topp = sampling_topp

    def _filter(self, lprobs):
        if self.topk > 0:
            kth = top_k(lprobs, self.topk)[0][..., -1:]
            lprobs = lprobs.masked_fill(lprobs < kth, float("-inf"))
        if self.topp > 0:
            sorted_lp = torch.sort(lprobs, dim=-1, descending=True, stable=True)[0]
            probs = sorted_lp.exp()
            # keep the tokens whose preceding cumulative mass is under topp
            keep_mass = probs.cumsum(dim=-1) - probs < self.topp
            cutoff = torch.where(keep_mass, sorted_lp, float("-inf")).amax(dim=-1, keepdim=True)
            lprobs = lprobs.masked_fill(lprobs < cutoff, float("-inf"))
        return lprobs

    def step(self, step_idx, lprobs, scores, generator=None):
        bsz, beam, v = lprobs.shape
        filt = self._filter(lprobs)
        u = torch.rand(filt.shape, generator=generator, device=filt.device).clamp(min=1e-20)
        sampled = (filt - torch.log(-torch.log(u))).argmax(dim=-1)  # (bsz, beam)
        tok_lp = lprobs.gather(-1, sampled[..., None])[..., 0]
        cum = tok_lp if scores is None else tok_lp + scores
        beams = torch.arange(beam, device=lprobs.device)[None].expand(bsz, beam)
        return (torch.cat([cum, torch.full_like(cum, float("-inf"))], dim=1),
                torch.cat([sampled, sampled], dim=1), torch.cat([beams, beams], dim=1))


class DiverseBeamSearch:
    """Vijayakumar et al. 2016: the beam in G groups; each group's lprobs are
    penalized by the counts of the tokens earlier groups chose this step
    (search.py:434-490, Hamming diversity)."""

    def __init__(self, num_groups: int, diversity_strength: float):
        self.groups = num_groups
        self.strength = diversity_strength
        self.inner = BeamSearch()

    def step(self, step_idx, lprobs, scores, generator=None):
        bsz, beam, v = lprobs.shape
        if beam % self.groups:
            raise ValueError(f"beam {beam} is not a multiple of {self.groups} groups")
        sub = beam // self.groups
        penalty = torch.zeros(bsz, v, dtype=lprobs.dtype, device=lprobs.device)
        outs = []
        for g in range(self.groups):
            lp = lprobs[:, g * sub:(g + 1) * sub] - self.strength * penalty[:, None, :]
            sc = None if scores is None else scores[:, g * sub:(g + 1) * sub]
            cs, ci, cb = self.inner.step(step_idx, lp, sc)
            cs, ci, cb = cs[:, :sub], ci[:, :sub], cb[:, :sub]
            outs.append((cs, ci, cb + g * sub))
            penalty = penalty + F.one_hot(ci, v).to(penalty.dtype).sum(dim=1)
        cand_scores, cand_indices, cand_beams = (torch.cat([o[i] for o in outs], dim=1)
                                                 for i in range(3))
        # the groups emit one beam in all: doubled to 2·beam
        return (torch.cat([cand_scores, torch.full_like(cand_scores, float("-inf"))], 1),
                torch.cat([cand_indices, cand_indices], 1),
                torch.cat([cand_beams, cand_beams], 1))


class DiverseSiblingsSearch:
    """Li & Jurafsky 2016: a rank-based penalty on each beam's k best
    siblings (search.py:618-695); the candidates report unpenalized scores."""

    def __init__(self, diversity_rate: float):
        self.rate = diversity_rate

    def step(self, step_idx, lprobs, scores, generator=None):
        bsz, beam, v = lprobs.shape
        k = 2 * beam
        if scores is not None:
            lprobs = lprobs + scores[:, :, None]
        lprobs = _first_beam_only(step_idx, lprobs)
        top_lp, top_idx = top_k(lprobs, k)  # (bsz, beam, k)
        rank = torch.arange(1, k + 1, dtype=lprobs.dtype, device=lprobs.device)
        penalized = (top_lp - self.rate * rank).reshape(bsz, beam * k)
        _, flat_i = top_k(penalized, k)
        cand_indices = top_idx.reshape(bsz, beam * k).gather(1, flat_i)
        cand_scores = top_lp.reshape(bsz, beam * k).gather(1, flat_i)
        return cand_scores, cand_indices, flat_i // k


class LengthConstrainedBeamSearch:
    """EOS off before min_len, only EOS from max_len (search.py:382-433)."""

    def __init__(self, min_len, max_len, eos: int):
        self.min_len = min_len
        self.max_len = max_len
        self.eos = eos
        self.inner = BeamSearch()

    def step(self, step_idx, lprobs, scores, generator=None):
        eos_col = torch.arange(lprobs.shape[-1], device=lprobs.device) == self.eos
        if step_idx < self.min_len:
            lprobs = lprobs.masked_fill(eos_col, float("-inf"))
        if step_idx >= self.max_len:
            lprobs = lprobs.masked_fill(~eos_col, float("-inf"))
        return self.inner.step(step_idx, lprobs, scores)


class PrefixConstrainedBeamSearch:
    """lprobs masked to the tokens a per-sentence function allows
    (search.py:491-547): ``allowed_mask_fn(step_idx) -> (bsz, V) bool``."""

    def __init__(self, allowed_mask_fn):
        self.allowed_mask_fn = allowed_mask_fn
        self.inner = BeamSearch()

    def step(self, step_idx, lprobs, scores, generator=None):
        mask = self.allowed_mask_fn(step_idx)
        return self.inner.step(step_idx, lprobs.masked_fill(~mask[:, None, :], float("-inf")),
                               scores)
