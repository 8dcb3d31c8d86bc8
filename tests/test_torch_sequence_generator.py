"""The port's sequence generator, search strategies, n-gram blocking, trie
and lexical constraints against the JAX package's (CPU), on scripted
Markov step functions (the reference's fixture strategy, as
tests/test_sequence_generator.py and tests/test_constrained_decoding.py
use it): the same table drives both generators, and the tokens must be
equal and the scores within 1e-5 (beams both sides leave at -inf compare
as -inf).  ``Sampling`` cannot match ``jax.random`` draw for draw: it is
held by its limits (top-k 1 and top-p → 0 equal greedy search) and by its
token frequencies over seeded draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.generate import search as tsearch
from ifseg_torch.generate.lexical import (
    lexical_advance as t_lex_advance,
    lexical_bank as t_lex_bank,
    lexical_init as t_lex_init,
    pack_constraints as t_pack,
)
from ifseg_torch.generate.sequence_generator import (
    SequenceGenerator as TGen,
    ensemble_step_fn as t_ensemble,
)
from ifseg_torch.generate.trie import (
    ConstraintTrie as TTrie,
    trie_advance as t_advance,
    trie_token_mask as t_mask,
)
from ifseg_torch.ops.ngram_block import ngram_repeat_mask as t_ngram
from ifseg_tpu.generate import search as jsearch
from ifseg_tpu.generate.lexical import pack_constraints as j_pack
from ifseg_tpu.generate.sequence_generator import (
    SequenceGenerator as JGen,
    ensemble_step_fn as j_ensemble,
)
from ifseg_tpu.generate.trie import ConstraintTrie as JTrie
from ifseg_tpu.ops.ngram_block import ngram_repeat_mask as j_ngram
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

BOS, PAD, EOS, UNK = 0, 1, 2, 3


def _table(v, seed, edits=()):
    t = np.random.default_rng(seed).random((v, v)) + 1e-3
    for (a, b), p in edits:
        t[a, b] = p
    return (t / t.sum(1, keepdims=True)).astype(np.float32)


def _j_step(table):
    logt = jnp.log(jnp.asarray(table))

    def step_fn(tokens, step, cache):
        return logt[tokens[:, step]], cache

    return step_fn


def _t_step(table):
    logt = torch.log(torch.from_numpy(table))

    def step_fn(tokens, step, cache):
        return logt[tokens[:, step]], cache

    return step_fn


def _trie(cls, seqs):
    t = cls(EOS)
    for s in seqs:
        t.insert([BOS] + list(s) + [EOS])
    return t.pack()


TRIE = [[5, 6], [5, 7, 8], [9, 10, 4, 11]]
# name -> (vocab, table seed, table edits, generator options, bsz, (jax, port) extras)
CASES = {
    "beam": (10, 0, (), dict(beam_size=3, max_len=5, min_len=1), 2),
    "pinned_length": (8, 1, (), dict(beam_size=3, max_len=4, min_len=4), 2),
    "min_len": (6, 2, [((BOS, EOS), 30.0)], dict(beam_size=2, max_len=6, min_len=3), 1),
    "max_len_forces_eos": (6, 3, [((r, 4), 50.0) for r in range(6)],
                           dict(beam_size=2, max_len=4, min_len=1), 1),
    "ngram_block": (8, 4, [((BOS, 4), 40.0), ((4, 5), 40.0), ((5, 4), 40.0)],
                    dict(beam_size=2, max_len=6, min_len=1, no_repeat_ngram_size=2), 1),
    "penalties": (9, 5, (), dict(beam_size=3, max_len=5, min_len=2, unk_penalty=0.7,
                                 temperature=1.3, len_penalty=0.5), 2),
    "trie": (12, 6, (), dict(beam_size=4, max_len=6, min_len=1), 2),
    "range": (16, 7, (), dict(beam_size=3, max_len=5, min_len=1, constraint_range="8,12"), 2),
    "zero_shot": (8, 8, (), dict(beam_size=2, max_len=4, min_len=1, zero_shot=True,
                                 normalize_scores=False), 1),
    "lexical": (12, 9, [((r, 5), 0.01) for r in range(12)],
                dict(beam_size=4, max_len=8, min_len=1), 2),
    "diverse_beam": (12, 10, (), dict(beam_size=4, max_len=5, min_len=1), 2),
    "diverse_siblings": (12, 11, (), dict(beam_size=3, max_len=5, min_len=1), 2),
    "length_constrained": (10, 12, (), dict(beam_size=3, max_len=5, min_len=1), 2),
    "prefix_constrained": (10, 13, (), dict(beam_size=3, max_len=5, min_len=1), 2),
}


def _options(name, side):
    """The options of ``CASES[name]`` that need each package's own objects."""
    j = side == "jax"
    if name in ("trie", "zero_shot"):
        seqs = TRIE if name == "trie" else [[5], [6, 7]]
        return dict(constraint_trie=_trie(JTrie if j else TTrie, seqs))
    if name == "lexical":
        return dict(lexical_constraints=(j_pack if j else t_pack)([[[5, 6], [9]], [[9]]]))
    s = jsearch if j else tsearch
    if name == "diverse_beam":
        return dict(search=s.DiverseBeamSearch(num_groups=2, diversity_strength=0.5))
    if name == "diverse_siblings":
        return dict(search=s.DiverseSiblingsSearch(diversity_rate=0.3))
    if name == "length_constrained":
        return dict(search=s.LengthConstrainedBeamSearch(2, 4, EOS))
    if name == "prefix_constrained":
        allowed = np.zeros((2, 10), bool)
        allowed[0, [2, 4, 5, 6]] = allowed[1, [2, 7, 8, 9]] = True
        mask = jnp.asarray(allowed) if j else torch.from_numpy(allowed)
        return dict(search=s.PrefixConstrainedBeamSearch(lambda step: mask))
    return {}


def _assert_same(got, want):
    ws, gs = np.asarray(want.scores), got.scores.numpy()
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


@pytest.mark.parametrize("name", list(CASES))
def test_generator_matches_jax(name):
    v, seed, edits, opts, bsz = CASES[name]
    table = _table(v, seed, edits)
    jgen = JGen(_j_step(table), v, **opts, **_options(name, "jax"))
    want = jax.jit(lambda: jgen(bsz=bsz, cache=()))()
    tgen = TGen(_t_step(table), v, **opts, **_options(name, "torch"))
    _assert_same(tgen(bsz, ()), want)


def test_ensemble_matches_jax():
    v = 8
    t1, t2 = _table(v, 20), _table(v, 21)
    opts = dict(beam_size=2, max_len=4, min_len=1)
    jgen = JGen(j_ensemble([_j_step(t1), _j_step(t2)]), v, **opts)
    want = jax.jit(lambda: jgen(bsz=2, cache=((), ())))()
    tgen = TGen(t_ensemble([_t_step(t1), _t_step(t2)]), v, **opts)
    _assert_same(tgen(2, ((), ())), want)


@pytest.mark.parametrize("cls", ["BeamSearch", "DiverseBeamSearch", "DiverseSiblingsSearch",
                                 "LengthConstrainedBeamSearch"])
@pytest.mark.parametrize("step", [0, 2])
def test_search_step_matches_jax(cls, step):
    rng = np.random.default_rng(30)
    lp = np.log(rng.dirichlet(np.ones(12), size=(2, 4))).astype(np.float32)
    scores = rng.normal(size=(2, 4)).astype(np.float32)
    args = {"DiverseBeamSearch": (2, 0.7), "DiverseSiblingsSearch": (0.4,),
            "LengthConstrainedBeamSearch": (1, 2, EOS)}.get(cls, ())
    want = getattr(jsearch, cls)(*args).step(step, jnp.asarray(lp), jnp.asarray(scores), None)
    got = getattr(tsearch, cls)(*args).step(step, torch.from_numpy(lp), torch.from_numpy(scores))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_ngram_mask_matches_jax():
    toks = np.random.default_rng(31).integers(0, 6, size=(5, 9)).astype(np.int32)
    j_mask = jax.jit(j_ngram, static_argnums=(2, 3))
    for n in (2, 3, 4):  # 1 is degenerate: the JAX function stacks no window
        for step in range(9):
            want = j_mask(jnp.asarray(toks), step, n, 7)
            got = t_ngram(torch.from_numpy(toks).long(), step, n, 7)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{n} {step}")


def test_trie_and_lexical_state_match_the_host_and_jax():
    seqs = [[5, 6], [5, 7, 8], [9]]
    host = TTrie(EOS)
    for s in seqs:
        host.insert([BOS] + s + [EOS])
    packed = host.pack()
    prefixes = [[BOS]] + [[BOS] + s[:k] for s in seqs for k in range(len(s) + 1)]
    for prefix in prefixes + [[BOS, 11], [BOS, 5, 5]]:
        node = torch.zeros((), dtype=torch.long)
        for tok in prefix:
            node = t_advance(packed, node, torch.tensor(tok))
        allowed = set(torch.nonzero(t_mask(packed, node, 12)).flatten().tolist())
        assert allowed == set(host.get_next_layer(prefix)), prefix
    cons = t_pack([[[5, 6], [9]]])
    prog = t_lex_init(cons, beam=1)
    for tok, bank in [(4, 0), (5, 1), (6, 2), (5, 2), (9, 3)]:
        prog = t_lex_advance(cons, prog, torch.full((1, 1), tok))
        assert int(t_lex_bank(cons, prog)[0, 0]) == bank, tok


@pytest.mark.parametrize("limit", ["topk1", "topp0"])
def test_sampling_at_its_limits_is_greedy(limit):
    table = _table(10, 40)
    search = (tsearch.Sampling(sampling_topk=1) if limit == "topk1"
              else tsearch.Sampling(sampling_topp=1e-6))
    opts = dict(beam_size=1, max_len=5, min_len=1)
    greedy = TGen(_t_step(table), 10, **opts)(2, ())
    sampled = TGen(_t_step(table), 10, search=search, **opts)(
        2, (), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(sampled.tokens.numpy(), greedy.tokens.numpy())
    np.testing.assert_allclose(sampled.scores.numpy(), greedy.scores.numpy(), atol=1e-6)


def test_sampling_frequencies_follow_the_filtered_distribution():
    rng = np.random.default_rng(41)
    probs = rng.dirichlet(np.ones(8)).astype(np.float32)
    n = 20000
    lp = torch.log(torch.from_numpy(probs)).expand(1, n, 8).contiguous()
    g = torch.Generator().manual_seed(1)
    for search, keep in ((tsearch.Sampling(), np.ones(8, bool)),
                         (tsearch.Sampling(sampling_topk=3), probs >= np.sort(probs)[-3])):
        _, idx, beams = search.step(1, lp, None, g)
        assert (beams[0, :n] == torch.arange(n)).all()
        freq = np.bincount(idx[0, :n].numpy(), minlength=8) / n
        want = np.where(keep, probs, 0) / probs[keep].sum()
        np.testing.assert_allclose(freq, want, atol=0.015)
