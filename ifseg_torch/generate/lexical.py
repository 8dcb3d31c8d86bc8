"""Lexically-constrained decoding state (the JAX package's
``generate/lexical.py``, a static-shape variant of the reference's
LexicallyConstrainedBeamSearch, Post & Vilar 2018 dynamic beam allocation).

Every finished hypothesis must contain all of its sentence's constraint
phrases.  The state is three integer tensors advanced by tensor ops:

- the constraints packed as a (bsz, C, L) token table and (bsz, C) lengths;
- the progress of each hypothesis (bsz, beam, C), the matched prefix
  length of each phrase;
- the bank, the constraint tokens consumed; EOS stays masked until it
  reaches the sentence's total.

Beam allocation as the JAX package simplifies it: half the beam by score,
half by (bank, score).  A mismatch restarts a phrase at "does this token
start it?" (no KMP fallback), fairseq's approximation for repeated prefixes.
"""

from typing import NamedTuple, Sequence

import numpy as np
import torch


class PackedConstraints(NamedTuple):
    tokens: torch.Tensor  # (bsz, C, L) int64, -1 padded
    lengths: torch.Tensor  # (bsz, C) int64, 0 = unused slot

    def to(self, device) -> "PackedConstraints":
        return PackedConstraints(self.tokens.to(device), self.lengths.to(device))


def pack_constraints(batch_phrases: Sequence[Sequence[Sequence[int]]],
                     device=None) -> PackedConstraints:
    """Per-sentence lists of constraint phrases packed into static tensors."""
    bsz = len(batch_phrases)
    c = max(1, max(len(p) for p in batch_phrases))
    l = max(1, max((len(ph) for p in batch_phrases for ph in p), default=1))
    tokens = np.full((bsz, c, l), -1, np.int64)
    lengths = np.zeros((bsz, c), np.int64)
    for b, phrases in enumerate(batch_phrases):
        for i, ph in enumerate(phrases):
            tokens[b, i, : len(ph)] = ph
            lengths[b, i] = len(ph)
    return PackedConstraints(torch.from_numpy(tokens).to(device),
                             torch.from_numpy(lengths).to(device))


def lexical_init(cons: PackedConstraints, beam: int) -> torch.Tensor:
    """The initial progress (bsz, beam, C), all zero."""
    bsz, c, _ = cons.tokens.shape
    return torch.zeros(bsz, beam, c, dtype=torch.long, device=cons.tokens.device)


def lexical_advance(cons: PackedConstraints, prog: torch.Tensor,
                    token: torch.Tensor) -> torch.Tensor:
    """The progress after emitting ``token``: prog (bsz, K, C), token
    (bsz, K).  Completed phrases stay completed."""
    tokens, lengths = cons.tokens, cons.lengths
    met = prog >= lengths[:, None, :]  # length-0 slots included
    pos = prog.clamp(max=tokens.shape[-1] - 1)
    table = tokens[:, None].expand(*prog.shape, tokens.shape[-1])
    expected = table.gather(-1, pos[..., None])[..., 0]  # (bsz, K, C)
    hit = expected == token[..., None]
    restart = (tokens[:, None, :, 0] == token[..., None]).long()
    new_prog = torch.where(hit, prog + 1, restart)
    return torch.where(met, prog, new_prog)


def lexical_bank(cons: PackedConstraints, prog: torch.Tensor) -> torch.Tensor:
    """Constraint tokens consumed per hypothesis (the DBA bank: partial
    progress counts, Post & Vilar 2018 §3)."""
    return torch.minimum(prog, cons.lengths[:, None, :]).sum(dim=-1)


def lexical_total(cons: PackedConstraints) -> torch.Tensor:
    """(bsz,) constraint tokens per sentence; bank == total iff every phrase
    is complete."""
    return cons.lengths.sum(dim=-1)
