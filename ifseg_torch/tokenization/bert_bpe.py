"""WordPiece tokenizer with BERT (uncased/cased) semantics, self-contained.

The reference's OFA-CN path selects ``bpe == 'bert'`` (tasks/ofa_task.py:169)
which is fairseq's BertBPE: a thin wrapper over HuggingFace's
``BertTokenizer(vocab_file, do_lower_case=not cased)`` whose ``encode``
returns space-joined token *strings* (the fairseq Dictionary built from
``BERT_CN_dict/dict.txt`` maps those to ids) and whose ``decode`` is
``clean_up_tokenization(convert_tokens_to_string(...))``.

This module re-implements that pipeline from the published algorithm
(basic tokenization -> greedy longest-match WordPiece) with no external
dependency, a copy of the JAX package's ``tokenization/bert_bpe.py``;
tests/test_torch_tokenization.py holds the two equal.
"""

import unicodedata
from typing import Iterable, List


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (BERT convention),
    # including characters like $ and ` that Unicode classes as symbols.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK pre-tokenizer with optional lowercasing."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        cleaned = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                cleaned.extend((" ", ch, " "))
            elif _is_whitespace(ch):
                cleaned.append(" ")
            else:
                cleaned.append(ch)
        out = []
        for tok in "".join(cleaned).split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(
                    c
                    for c in unicodedata.normalize("NFD", tok)
                    if unicodedata.category(c) != "Mn"
                )
            out.extend(self._split_punct(tok))
        return out

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        parts, cur = [], []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    parts.append("".join(cur))
                    cur = []
                parts.append(ch)
            else:
                cur.append(ch)
        if cur:
            parts.append("".join(cur))
        return parts


class WordPiece:
    """Greedy longest-match-first subword split against a vocab."""

    def __init__(self, vocab, unk_token="[UNK]", max_chars_per_word=100):
        self.vocab = vocab if isinstance(vocab, set) else set(vocab)
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


_CLEANUP = [
    (" .", "."),
    (" ?", "?"),
    (" !", "!"),
    (" ,", ","),
    (" ' ", "'"),
    (" n't", "n't"),
    (" 'm", "'m"),
    (" 's", "'s"),
    (" 've", "'ve"),
    (" 're", "'re"),
]


class BertBPE:
    """fairseq-BertBPE-compatible encode/decode over a vocab.txt file.

    ``encode`` returns space-joined WordPiece token strings (ids come from
    the task Dictionary, matching the reference's two-stage mapping);
    ``decode`` merges '##' continuations and applies HF's tokenization
    cleanup rules.
    """

    def __init__(self, vocab_file: str, cased: bool = False):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab_list = [line.rstrip("\n") for line in f if line.strip()]
        self.basic = BasicTokenizer(do_lower_case=not cased)
        self.wordpiece = WordPiece(self.vocab_list)

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def encode(self, text: str) -> str:
        return " ".join(self.tokenize(text))

    def decode(self, s: str) -> str:
        return self.decode_tokens(s.split(" "))

    @staticmethod
    def decode_tokens(tokens: Iterable[str]) -> str:
        text = " ".join(tokens).replace(" ##", "").strip()
        for a, b in _CLEANUP:
            text = text.replace(a, b)
        return text

    @staticmethod
    def is_beginning_of_word(x: str) -> bool:
        return not x.startswith("##")
