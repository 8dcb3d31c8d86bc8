"""The port's balanced assignments (``ifseg_torch.ops.balanced_assignment``)
against the JAX package's on the same numpy-seeded scores.

Sinkhorn (torch ops) and the auction (the port's copy of the host C++,
built by ``ops/build.py``) give the JAX functions' expert ids exactly, each
expert exactly N/E tokens, at several shapes; one case is the adversarial
one where every token prefers expert 0, then 1, then 2.  On the random
scores the auction's total score is at least Sinkhorn's, as the JAX
package's own test has it; on the adversarial ones it is not, there or
here (1400.31 against 1400.89 at 64 x 8: the same ids as the JAX
auction's).
"""

import numpy as np
import pytest

SHAPES = {  # name: (tokens, experts, seed)
    "32x4": (32, 4, 0),
    "64x8": (64, 8, 1),
    "96x2": (96, 2, 2),
    "130x2": (130, 2, 3),
    "adversarial-64x8": (64, 8, 4),
}


def _scores(name):
    n, e, seed = SHAPES[name]
    rng = np.random.default_rng(seed)
    if name.startswith("adversarial"):
        s = rng.normal(size=(n, e)).astype(np.float32) * 0.01
        s[:, 0] += 100.0  # everyone wants expert 0, then 1, then 2
        s[:, 1] += 50.0
        s[:, 2] += 25.0
        return s
    return rng.normal(size=(n, e)).astype(np.float32)


@pytest.mark.parametrize("method", ["sinkhorn", "auction"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_assignment_matches_jax_with_exact_balance(name, method):
    import jax
    import jax.numpy as jnp
    import torch

    from ifseg_torch.ops import balanced_assignment as tba
    from ifseg_tpu.ops import balanced_assignment as jba

    scores = _scores(name)
    n, e, _ = SHAPES[name]
    got = getattr(tba, f"balanced_assignment_{method}")(torch.from_numpy(scores)).numpy()
    jfn = getattr(jba, f"balanced_assignment_{method}")
    want = np.asarray(jax.jit(jfn)(jnp.asarray(scores)) if method == "sinkhorn"
                      else jfn(jnp.asarray(scores)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.bincount(got, minlength=e), np.full(e, n // e))


@pytest.mark.parametrize("name", sorted(n for n in SHAPES if not n.startswith("adversarial")))
def test_auction_scores_at_least_sinkhorn(name):
    import torch

    from ifseg_torch.ops.balanced_assignment import (
        balanced_assignment_auction,
        balanced_assignment_sinkhorn,
    )

    scores = torch.from_numpy(_scores(name))
    rows = torch.arange(scores.shape[0])
    total = lambda ids: float(scores[rows, ids].sum())
    assert total(balanced_assignment_auction(scores)) >= total(
        balanced_assignment_sinkhorn(scores)) - 1e-3
