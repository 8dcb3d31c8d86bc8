"""Constraint trie for constrained decoding, packed for lookup on the device.

The JAX package's ``generate/trie.py``: the reference's utils/trie.py walks
a dict-of-dicts trie on the host every step; here the trie is packed once
into (num_nodes, max_branch) child tables, and the mask lookup and the state
advance are tensor ops on the generator's device:

    node state (int64 per hypothesis)
      trie_token_mask(packed, node, vocab) -> (..., vocab) bool, allowed next tokens
      trie_advance(packed, node, tok)      -> next node (-1 = off the trie)

Off-trie and leaf states allow only EOS, the reference's fallback.
"""

from typing import List, NamedTuple, Sequence

import numpy as np
import torch


class ConstraintTrie:
    """Host-side trie with the reference's API (utils/trie.py)."""

    def __init__(self, eos: int):
        self.eos = eos
        # node 0 is the root; each node maps token -> child node id
        self._children: List[dict] = [{}]

    def insert(self, word: Sequence[int]) -> None:
        cur = 0
        for tok in word:
            tok = int(tok)
            nxt = self._children[cur].get(tok)
            if nxt is None:
                nxt = len(self._children)
                self._children.append({})
                self._children[cur][tok] = nxt
            cur = nxt

    def get_next_layer(self, word: Sequence[int]) -> List[int]:
        cur = 0
        for tok in word:
            cur = self._children[cur].get(int(tok))
            if cur is None:
                return [self.eos]
        return list(self._children[cur].keys())

    def pack(self, device=None) -> "PackedTrie":
        """The child tables, each node's children in token order, -1 padded."""
        max_branch = max(1, max(len(c) for c in self._children))
        n = len(self._children)
        tokens = np.full((n, max_branch), -1, np.int64)
        ids = np.full((n, max_branch), -1, np.int64)
        for i, children in enumerate(self._children):
            for j, (tok, child) in enumerate(sorted(children.items())):
                tokens[i, j] = tok
                ids[i, j] = child
        return PackedTrie(torch.from_numpy(tokens).to(device), torch.from_numpy(ids).to(device),
                          self.eos)


class PackedTrie(NamedTuple):
    children_tokens: torch.Tensor  # (N, B) int64, -1 padded
    children_ids: torch.Tensor  # (N, B) int64, -1 padded
    eos: int

    def to(self, device) -> "PackedTrie":
        return PackedTrie(self.children_tokens.to(device), self.children_ids.to(device), self.eos)


def trie_token_mask(trie: PackedTrie, node: torch.Tensor, vocab: int) -> torch.Tensor:
    """Allowed-next-token mask over the leading dims of ``node``.  Off-trie
    (node < 0) and leaf nodes allow only EOS."""
    toks = trie.children_tokens[node.clamp(min=0)]  # (..., B)
    valid = toks >= 0
    ids = torch.arange(vocab, device=node.device)
    onehot = ids == torch.where(valid, toks, 0)[..., None]
    mask = (onehot & valid[..., None]).any(dim=-2)
    dead = (node < 0) | ~valid.any(dim=-1)
    return torch.where(dead[..., None], ids == trie.eos, mask)


def trie_advance(trie: PackedTrie, node: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """The next node after emitting ``token``; -1 once off the trie (absorbing)."""
    safe = node.clamp(min=0)
    toks = trie.children_tokens[safe]
    hit = (toks == token[..., None]) & (toks >= 0)
    child = torch.where(hit, trie.children_ids[safe], -1).amax(dim=-1)
    return torch.where(node < 0, -1, child)
