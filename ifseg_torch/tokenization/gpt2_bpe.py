r"""GPT-2 byte-level BPE, self-contained.

Replicates the tokenization used by the reference via fairseq's GPT2BPE wrapper
(reference: custom_fairseq/fairseq/data/encoders/gpt2_bpe.py and
custom_fairseq/fairseq/data/encoders/gpt2_bpe_utils.py behavior): text is split
by the GPT-2 pre-tokenizer, bytes are mapped to unicode surrogates, merges
applied greedily by rank, and `encode` returns the GPT-2 token ids joined as a
space-separated string (which the fairseq Dictionary then maps to its indices).

A copy of the JAX package's ``tokenization/gpt2_bpe.py`` except for the
pre-tokenizer: that one applies the regular expression

    's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+

with the ``regex`` package, which the standard library's ``re`` cannot (it
has no ``\p{L}``, and ``[^\W\d_]`` also takes the ``No`` and ``Nl``
characters).  ``pretokenize`` is a scanner that tries the same alternatives
in the same order at each position, with ``regex``'s whitespace class and
its letter and number classes: ``unicodedata``'s categories, and for the
code points this Python's database leaves unassigned (``regex`` carries a
newer Unicode) the table ``_NEWER_LN``.  ``tests/test_torch_tokenization.py``
holds the classes equal to ``regex``'s on every code point.
"""

import bisect
import json
import os
import unicodedata
from functools import lru_cache
from typing import List

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


# (first, last, class) of the code points that ``regex`` classes as \p{L}
# or \p{N} and Python 3.12's ``unicodedata`` (Unicode 15.0) leaves
# unassigned (category Cn): 9,568 letters and 93 numbers of later Unicode
# versions.  Made with ``regex`` 2026.7.19 by walking every code point c
# with category(c) == "Cn" and merging the runs of equal
# ``"L" if regex.match(r"\p{L}", c) else "N" if regex.match(r"\p{N}", c)``.
_NEWER_LN = (
    (0x0088F, 0x0088F, "L"), (0x00C5C, 0x00C5C, "L"), (0x00CDC, 0x00CDC, "L"),
    (0x01C89, 0x01C8A, "L"), (0x0A7CB, 0x0A7CF, "L"), (0x0A7D2, 0x0A7D2, "L"),
    (0x0A7D4, 0x0A7D4, "L"), (0x0A7DA, 0x0A7DC, "L"), (0x0A7F1, 0x0A7F1, "L"),
    (0x105C0, 0x105F3, "L"), (0x10940, 0x10959, "L"), (0x10D40, 0x10D49, "N"),
    (0x10D4A, 0x10D65, "L"), (0x10D6F, 0x10D85, "L"), (0x10EC2, 0x10EC7, "L"),
    (0x11380, 0x11389, "L"), (0x1138B, 0x1138B, "L"), (0x1138E, 0x1138E, "L"),
    (0x11390, 0x113B5, "L"), (0x113B7, 0x113B7, "L"), (0x113D1, 0x113D1, "L"),
    (0x113D3, 0x113D3, "L"), (0x116D0, 0x116E3, "N"), (0x11BC0, 0x11BE0, "L"),
    (0x11BF0, 0x11BF9, "N"), (0x11DB0, 0x11DDB, "L"), (0x11DE0, 0x11DE9, "N"),
    (0x13460, 0x143FA, "L"), (0x16100, 0x1611D, "L"), (0x16130, 0x16139, "N"),
    (0x16D40, 0x16D6C, "L"), (0x16D70, 0x16D79, "N"), (0x16EA0, 0x16EB8, "L"),
    (0x16EBB, 0x16ED3, "L"), (0x16FF2, 0x16FF3, "L"), (0x16FF4, 0x16FF6, "N"),
    (0x187F8, 0x187FF, "L"), (0x18CFF, 0x18CFF, "L"), (0x18D09, 0x18D1E, "L"),
    (0x18D80, 0x18DF2, "L"), (0x1CCF0, 0x1CCF9, "N"), (0x1E5D0, 0x1E5ED, "L"),
    (0x1E5F0, 0x1E5F0, "L"), (0x1E5F1, 0x1E5FA, "N"), (0x1E6C0, 0x1E6DE, "L"),
    (0x1E6E0, 0x1E6E2, "L"), (0x1E6E4, 0x1E6E5, "L"), (0x1E6E7, 0x1E6ED, "L"),
    (0x1E6F0, 0x1E6F4, "L"), (0x1E6FE, 0x1E6FF, "L"), (0x2B73A, 0x2B73F, "L"),
    (0x2CEA2, 0x2CEAD, "L"), (0x2EBF0, 0x2EE5D, "L"), (0x323B0, 0x33479, "L"),
)
_NEWER_FIRST = [first for first, _, _ in _NEWER_LN]


def _kind(c: str) -> str:
    r"""'S' whitespace, 'L' letter, 'N' number, 'O' anything else.  Whitespace
    is ``str.isspace`` without U+001C..U+001F, which ``regex``'s ``\s`` does
    not take."""
    if c.isspace() and not "\x1c" <= c <= "\x1f":
        return "S"
    cat = unicodedata.category(c)
    if cat == "Cn":
        i = bisect.bisect_right(_NEWER_FIRST, ord(c)) - 1
        return _NEWER_LN[i][2] if i >= 0 and ord(c) <= _NEWER_LN[i][1] else "O"
    return cat[0] if cat[0] in "LN" else "O"


def pretokenize(text: str) -> List[str]:
    r"""``regex.findall`` of the GPT-2 pattern over ``text``: at each position
    the first alternative that matches, in the pattern's order."""
    kinds = [_kind(c) for c in text]
    n = len(text)
    out = []
    i = 0
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        if kinds[i] != "S" or (text[i] == " " and i + 1 < n and kinds[i + 1] != "S"):
            # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+': an optional
            # space, then the longest run of one class
            j = i + 1 if kinds[i] == "S" else i
            k = kinds[j]
            j += 1
            while j < n and kinds[j] == k:
                j += 1
            out.append(text[i:j])
            i = j
            continue
        # '\s+(?!\S)', else '\s+': a run of whitespace, less its last
        # character when a non-space follows and the run is longer than one
        j = i + 1
        while j < n and kinds[j] == "S":
            j += 1
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


@lru_cache()
def bytes_to_unicode():
    """Map every byte to a printable unicode char (GPT-2 convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class GPT2BPE:
    def __init__(self, encoder_json: str, vocab_bpe: str):
        with open(encoder_json, "r", encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(vocab_bpe, "r", encoding="utf-8") as f:
            bpe_data = f.read()
        merges = [tuple(line.split()) for line in bpe_data.split("\n")[1:-1]]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache = {}

    @classmethod
    def from_dir(cls, bpe_dir: str) -> "GPT2BPE":
        return cls(
            os.path.join(bpe_dir, "encoder.json"), os.path.join(bpe_dir, "vocab.bpe")
        )

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode_ids(self, text: str):
        """Text -> list of GPT-2 token ids."""
        ids = []
        for token in pretokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def encode(self, text: str) -> str:
        """Text -> space-joined GPT-2 ids (fairseq GPT2BPE.encode convention)."""
        return " ".join(str(i) for i in self.encode_ids(text))

    def decode_ids(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace"
        )

    def decode(self, s: str) -> str:
        """Space-joined GPT-2 ids -> text (inverse of `encode`)."""
        return self.decode_ids(int(t) for t in s.split())
