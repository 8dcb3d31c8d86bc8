"""Static-shape beam-search sequence generator (the JAX package's
``generate/sequence_generator.py``; reference models/sequence_generator.py).

Beam search with min/max length, length-penalty-normalized finalization,
2×beam candidates so EOS never starves the beam, no-repeat-ngram blocking,
temperature, the unk penalty, trie / range / ``zero_shot`` constraints and
lexical constraints.  The JAX package compiles one ``lax.scan`` over
``max_len + 1`` steps; here the same body runs in a Python loop over the
same static shapes and masks, so the tokens and scores are the same.

``step_fn(prev_tokens (N, Lmax), step, cache) -> (logits (N, V), cache)``
with N = bsz · beam; the model owns its cache (``models/ar_cache.py``), and
the generator reorders it by the surviving beams each step.  The seg pin
max_len == min_len (sequence_generator.py:227-229) is a min/max setting.
"""

from typing import Any, Callable, NamedTuple, Optional

import torch

from ifseg_torch.generate.lexical import (
    PackedConstraints,
    lexical_advance,
    lexical_bank,
    lexical_init,
    lexical_total,
)
from ifseg_torch.generate.search import BeamSearch, top_k
from ifseg_torch.generate.trie import PackedTrie, trie_advance, trie_token_mask
from ifseg_torch.ops.ngram_block import ngram_repeat_mask

NEG_INF = -1e9
_INF = float("inf")


def _reorder_cache(cache, flat_sel: torch.Tensor, nrows: int):
    """The cache's rows gathered by the selected beams.  An ``ARCache`` is
    reordered structurally (its biases are batch-independent and stay as
    they are even where their leading axis happens to equal bsz·beam); a
    tuple of caches (an ensemble) member by member; any other structure of
    tensors by the batch-major shape rule."""
    from ifseg_torch.models.ar_cache import ARCache

    take = lambda c: c.index_select(0, flat_sel)
    if isinstance(cache, ARCache):
        return cache._replace(
            self_k=[take(k) for k in cache.self_k], self_v=[take(v) for v in cache.self_v],
            cross_k=[take(k) for k in cache.cross_k], cross_v=[take(v) for v in cache.cross_v],
            enc_out=take(cache.enc_out), enc_pad=take(cache.enc_pad))
    if isinstance(cache, (tuple, list)):
        return type(cache)(_reorder_cache(c, flat_sel, nrows) for c in cache)
    if isinstance(cache, dict):
        return {k: _reorder_cache(v, flat_sel, nrows) for k, v in cache.items()}
    if isinstance(cache, torch.Tensor) and cache.dim() >= 1 and cache.shape[0] == nrows:
        return take(cache)
    return cache


def ensemble_step_fn(step_fns, temperature: float = 1.0):
    """An ensemble's next-token distributions averaged in probability space
    (EnsembleModel, sequence_generator.py:899-900: the logsumexp of the
    members' log-probabilities minus log n).  Each step_fn owns one slot of
    the cache tuple.  The reference tempers each member before normalizing,
    so pass ``temperature`` here and leave the generator's at 1.0."""
    n = len(step_fns)
    if n == 1:
        return step_fns[0]

    def step_fn(tokens, step, caches):
        lps, new_caches = [], []
        for fn, cache in zip(step_fns, caches):
            logits, new_cache = fn(tokens, step, cache)
            lps.append(torch.log_softmax(logits.float() / temperature, dim=-1))
            new_caches.append(new_cache)
        avg = torch.logsumexp(torch.stack(lps), dim=0) - torch.log(torch.tensor(float(n)))
        return avg, tuple(new_caches)

    return step_fn


class GeneratorOutput(NamedTuple):
    tokens: torch.Tensor  # (bsz, beam, Lmax) best first, EOS-terminated
    scores: torch.Tensor  # (bsz, beam) length-normalized


class SequenceGenerator:
    def __init__(
        self,
        step_fn: Callable,
        vocab_size: int,
        beam_size: int = 5,
        max_len: int = 200,
        min_len: int = 1,
        bos: int = 0,
        pad: int = 1,
        eos: int = 2,
        unk: int = 3,
        normalize_scores: bool = True,
        len_penalty: float = 1.0,
        unk_penalty: float = 0.0,
        temperature: float = 1.0,
        no_repeat_ngram_size: int = 0,
        search=None,
        constraint_trie: Optional[PackedTrie] = None,
        constraint_range: Optional[str] = None,
        zero_shot: bool = False,
        lexical_constraints: Optional[PackedConstraints] = None,
        device=None,
    ):
        """``device``: where the generator's own state lives (the step
        function's logits must be there); the CPU unless given."""
        self.step_fn = step_fn
        self.vocab_size = vocab_size
        self.beam = beam_size
        self.max_len = max_len
        self.min_len = min_len
        self.bos, self.pad, self.eos, self.unk = bos, pad, eos, unk
        self.normalize_scores = normalize_scores
        self.len_penalty = len_penalty
        self.unk_penalty = unk_penalty
        self.temperature = temperature
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self.search = search or BeamSearch()
        # constrained decoding (sequence_generator.py:130-137, :855-888):
        # constraint_range="start,end" keeps ids [0, 4) and [start, end);
        # constraint_trie keeps each hypothesis on the trie's continuations;
        # zero_shot masks after the log_softmax (raw scores over the whole
        # vocab), otherwise before (the allowed set renormalizes)
        self.constraint_trie = constraint_trie
        self.zero_shot = zero_shot
        self.constraint_start = self.constraint_end = None
        if constraint_range is not None:
            start, end = constraint_range.split(",")
            self.constraint_start, self.constraint_end = int(start), int(end)
        self.lexical = lexical_constraints
        self.device = torch.device("cpu" if device is None else device)
        self.initial_cache = ()

    def _constraint_mask(self, nodes_flat) -> Optional[torch.Tensor]:
        """(N, V) True = allowed, from the range and / or trie constraints."""
        v = self.vocab_size
        mask = None
        if self.constraint_start is not None:
            ids = torch.arange(v, device=nodes_flat.device)
            mask = (ids < 4) | ((ids >= self.constraint_start) & (ids < self.constraint_end))
            mask = mask.expand(nodes_flat.shape[0], v)
        if self.constraint_trie is not None:
            tmask = trie_token_mask(self.constraint_trie, nodes_flat, v)
            mask = tmask if mask is None else (mask & tmask)
        return mask

    @torch.no_grad()
    def __call__(self, bsz: int, cache: Any, generator: Optional[torch.Generator] = None
                 ) -> GeneratorOutput:
        """Generate for ``bsz`` sentences from ``cache`` (the model's, e.g.
        ``initial_cache``); ``generator`` feeds a sampling search."""
        beam, v, dev = self.beam, self.vocab_size, self.device
        lmax = self.max_len + 2  # bos + tokens + eos
        if self.constraint_trie is not None:
            self.constraint_trie = self.constraint_trie.to(dev)
        lex = None if self.lexical is None else self.lexical.to(dev)
        ar = lambda n: torch.arange(n, device=dev)

        tokens = torch.full((bsz, beam, lmax), self.pad, dtype=torch.long, device=dev)
        tokens[:, :, 0] = self.bos
        nodes = torch.zeros(bsz, beam, dtype=torch.long, device=dev)
        if self.constraint_trie is not None:
            # trie sequences are inserted as [bos] + tokens + [eos]
            # (sequence_generator.py:862 walks "[0] + generated suffix")
            nodes = trie_advance(self.constraint_trie, nodes, torch.full_like(nodes, self.bos))
        prog = (lexical_init(lex, beam) if lex is not None
                else torch.zeros(bsz, beam, 1, dtype=torch.long, device=dev))
        alive_lp = torch.zeros(bsz, beam, device=dev)
        fin_seq = torch.full((bsz, beam, lmax), self.pad, dtype=torch.long, device=dev)
        fin_scores = torch.full((bsz, beam), -_INF, device=dev)
        eos_col = (ar(v) == self.eos)[None, None, :]

        for step in range(self.max_len + 1):
            flat_tokens = tokens.reshape(bsz * beam, lmax)
            logits, cache = self.step_fn(flat_tokens, step, cache)
            logits = logits.float()
            cmask = self._constraint_mask(nodes.reshape(bsz * beam))
            if cmask is not None and not self.zero_shot:
                logits = torch.where(cmask, logits, NEG_INF)
            lprobs = torch.log_softmax(logits / self.temperature, dim=-1)
            if cmask is not None and self.zero_shot:
                lprobs = lprobs.masked_fill(~cmask, -_INF)
            lprobs[:, self.pad] = -_INF
            if self.unk_penalty != 0.0:
                lprobs[:, self.unk] -= self.unk_penalty
            if self.no_repeat_ngram_size > 0:
                banned = ngram_repeat_mask(flat_tokens, step, self.no_repeat_ngram_size, v)
                lprobs = lprobs.masked_fill(banned, -_INF)
            lprobs = lprobs.reshape(bsz, beam, v)
            # min/max length by EOS gating: at step s the token at position
            # s + 1 is chosen; EOS at step s ends a hypothesis of s tokens
            if lex is not None:
                unmet = lexical_bank(lex, prog) < lexical_total(lex)[:, None]
                lprobs = lprobs.masked_fill(unmet[..., None] & eos_col, -_INF)
            if step < self.min_len:
                lprobs = lprobs.masked_fill(eos_col, -_INF)
            if step >= self.max_len:
                lprobs = lprobs.masked_fill(~eos_col, NEG_INF)

            cand_scores, cand_indices, cand_beams = self.search.step(
                step, lprobs, alive_lp, generator)  # each (bsz, 2·beam)

            if lex is not None:
                # each beam's expected next constraint tokens and its EOS join
                # the candidates: a low-probability constraint token never
                # survives the top-2B cut on its own
                ctoks, clens = lex.tokens, lex.lengths
                c, l = ctoks.shape[1], ctoks.shape[2]
                exp_tok = ctoks[:, None].expand(bsz, beam, c, l).gather(
                    -1, prog.clamp(max=l - 1)[..., None])[..., 0].clamp(0, v - 1)
                inactive = (prog >= clens[:, None, :]) | (clens[:, None, :] == 0)
                lp_exp = lprobs.gather(-1, exp_tok)
                sc_exp = torch.where(inactive, -_INF, alive_lp[..., None] + lp_exp)
                beams_exp = ar(beam)[None, :, None].expand(bsz, beam, c)
                cand_scores = torch.cat([cand_scores, sc_exp.reshape(bsz, beam * c),
                                         alive_lp + lprobs[..., self.eos]], dim=1)
                cand_indices = torch.cat([cand_indices, exp_tok.reshape(bsz, beam * c),
                                          torch.full((bsz, beam), self.eos, device=dev)], dim=1)
                cand_beams = torch.cat([cand_beams, beams_exp.reshape(bsz, beam * c),
                                        ar(beam)[None].expand(bsz, beam)], dim=1)

            is_eos = cand_indices == self.eos
            length = torch.tensor(float(step + 1))
            norm = float(length ** self.len_penalty) if self.normalize_scores else 1.0
            eos_norm_scores = torch.where(is_eos, cand_scores / norm, -_INF)

            # finalize: EOS candidates merge into the finished pool
            n_cand = cand_beams.shape[1]
            cand_seq = tokens.gather(
                1, cand_beams.clamp(0, beam - 1)[:, :, None].expand(bsz, n_cand, lmax)).clone()
            cand_seq[:, :, step + 1] = torch.where(is_eos, self.eos, cand_indices)
            all_fin_scores = torch.cat([fin_scores, eos_norm_scores], dim=1)
            all_fin_seq = torch.cat([fin_seq, cand_seq], dim=1)
            fin_scores, top_fin_idx = top_k(all_fin_scores, beam)
            fin_seq = all_fin_seq.gather(1, top_fin_idx[:, :, None].expand(bsz, beam, lmax))

            # continue: the best candidates that are not EOS
            alive_cand = torch.where(is_eos, -_INF, cand_scores)
            if lex is not None:
                # half the beam by score, half by (bank, score)
                prog_cand = prog.gather(
                    1, cand_beams.clamp(0, beam - 1)[:, :, None].expand(bsz, n_cand, prog.shape[2]))
                cand_bank = lexical_bank(lex, lexical_advance(lex, prog_cand, cand_indices)).float()
                k2 = beam // 2
                _, i1 = top_k(alive_cand, beam - k2)
                masked = alive_cand.scatter(1, i1, -_INF)
                _, i2 = top_k(masked + cand_bank * 1e4, k2)
                alive_idx = torch.cat([i1, i2], dim=1)
                new_alive_lp = alive_cand.gather(1, alive_idx)
            else:
                new_alive_lp, alive_idx = top_k(alive_cand, beam)
            new_tokens = cand_seq.gather(1, alive_idx[:, :, None].expand(bsz, beam, lmax))
            sel_beams = cand_beams.gather(1, alive_idx)  # (bsz, beam)
            flat_sel = (ar(bsz)[:, None] * beam + sel_beams).reshape(-1)
            cache = _reorder_cache(cache, flat_sel, bsz * beam)
            chosen = new_tokens[:, :, step + 1]
            if self.constraint_trie is not None:
                nodes = trie_advance(self.constraint_trie, nodes.gather(1, sel_beams), chosen)
            if lex is not None:
                prog = lexical_advance(
                    lex, prog.gather(1, sel_beams[:, :, None].expand(bsz, beam, prog.shape[2])),
                    chosen)
            tokens, alive_lp = new_tokens, new_alive_lp

        if lex is not None:
            # a beam that never finished counts only with its constraints met
            done = lexical_bank(lex, prog) >= lexical_total(lex)[:, None]
            alive_lp = torch.where(done, alive_lp, -_INF)
        # beams that never finished: finished at the maximum length
        norm = (float(torch.tensor(float(self.max_len + 1)) ** self.len_penalty)
                if self.normalize_scores else 1.0)
        all_scores = torch.cat([fin_scores, alive_lp / norm], dim=1)
        all_seq = torch.cat([fin_seq, tokens], dim=1)
        top, idx = top_k(all_scores, beam)
        return GeneratorOutput(tokens=all_seq.gather(1, idx[:, :, None].expand(bsz, beam, lmax)),
                               scores=top)
