"""Sequence scoring: corpus BLEU, edit distance and word error rate,
ROUGE-L and CIDEr-D.

The port's copy of the JAX package's ``utils/scoring.py`` (pure Python, the
same results): capability parity with fairseq/scoring/ and clib/libbleu's
corpus BLEU.  Scoring at segmentation scale is not a hot path.
"""

import math
from collections import Counter
from typing import Iterable, List, Sequence, Tuple


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    hypotheses: Iterable[Sequence],
    references: Iterable[Sequence],
    max_order: int = 4,
    smooth: bool = False,
) -> dict:
    """Corpus-level BLEU (clib/libbleu semantics: clipped n-gram precision
    products with brevity penalty)."""
    matches = [0] * max_order
    totals = [0] * max_order
    hyp_len = 0
    ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        hyp = list(hyp)
        ref = list(ref)
        hyp_len += len(hyp)
        ref_len += len(ref)
        for n in range(1, max_order + 1):
            h = _ngrams(hyp, n)
            r = _ngrams(ref, n)
            overlap = sum((h & r).values())
            matches[n - 1] += overlap
            totals[n - 1] += max(len(hyp) - n + 1, 0)

    precisions = []
    for m, t in zip(matches, totals):
        if smooth:
            precisions.append((m + 1.0) / (t + 1.0))
        else:
            precisions.append(m / t if t > 0 else 0.0)
    if min(precisions) > 0:
        log_p = sum(math.log(p) for p in precisions) / max_order
        geo = math.exp(log_p)
    else:
        geo = 0.0
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return {
        "bleu": 100.0 * geo * bp,
        "precisions": precisions,
        "brevity_penalty": bp,
        "hyp_len": hyp_len,
        "ref_len": ref_len,
    }


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance (clib/libnat edit_dist equivalent, host-side)."""
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (a[i - 1] != b[j - 1]),
            )
        prev = cur
    return prev[lb]


def wer(hypothesis: Sequence, reference: Sequence) -> float:
    """Word error rate = edit_distance / len(reference)."""
    if len(reference) == 0:
        return 0.0 if len(hypothesis) == 0 else 1.0
    return edit_distance(hypothesis, reference) / len(reference)


def _lcs_len(a: Sequence, b: Sequence) -> int:
    la, lb = len(a), len(b)
    prev = [0] * (lb + 1)
    for i in range(1, la + 1):
        cur = [0] * (lb + 1)
        for j in range(1, lb + 1):
            cur[j] = (
                prev[j - 1] + 1 if a[i - 1] == b[j - 1] else max(prev[j], cur[j - 1])
            )
        prev = cur
    return prev[lb]


def rouge_l(hypothesis: Sequence, reference: Sequence, beta: float = 1.2) -> dict:
    """ROUGE-L F/P/R (reference utils/rouge.py semantics: LCS-based)."""
    lcs = _lcs_len(hypothesis, reference)
    p = lcs / len(hypothesis) if hypothesis else 0.0
    r = lcs / len(reference) if reference else 0.0
    if p == 0 or r == 0:
        f = 0.0
    else:
        f = (1 + beta**2) * p * r / (r + beta**2 * p)
    return {"f": f, "p": p, "r": r}


def cider_d(
    hypotheses: Sequence[Sequence],
    references: Sequence[Sequence[Sequence]],
    max_order: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D (Vedantam et al. 2015; reference utils/cider/): tf-idf weighted
    n-gram cosine with a Gaussian length penalty, averaged over orders,
    scaled by 10.  ``references[i]`` is a list of reference sequences."""
    n_imgs = len(hypotheses)
    assert len(references) == n_imgs

    # document frequency over reference sets
    df: Counter = Counter()
    for refs in references:
        seen = set()
        for ref in refs:
            for n in range(1, max_order + 1):
                seen.update(_ngrams(list(ref), n).keys())
        df.update(seen)
    log_n = math.log(max(n_imgs, 1))

    def tfidf(tokens):
        vecs = []
        norms = []
        for n in range(1, max_order + 1):
            counts = _ngrams(list(tokens), n)
            vec = {}
            for gram, c in counts.items():
                idf = log_n - math.log(max(df.get(gram, 1), 1))
                vec[gram] = c * max(idf, 0.0)
            vecs.append(vec)
            norms.append(math.sqrt(sum(v * v for v in vec.values())))
        return vecs, norms

    total = 0.0
    for hyp, refs in zip(hypotheses, references):
        hv, hn = tfidf(hyp)
        score_i = 0.0
        for ref in refs:
            rv, rn = tfidf(ref)
            delta = len(hyp) - len(ref)
            length_pen = math.exp(-(delta**2) / (2 * sigma**2))
            s = 0.0
            for n in range(max_order):
                # CIDEr-D clips the hypothesis tf-idf by the reference's
                num = sum(
                    min(hv[n][g], rv[n].get(g, 0.0)) * rv[n].get(g, 0.0)
                    for g in hv[n]
                )
                den = hn[n] * rn[n]
                s += (num / den if den > 0 else 0.0) * length_pen
            score_i += s / max_order
        total += 10.0 * score_i / max(len(refs), 1)
    return total / max(n_imgs, 1)
