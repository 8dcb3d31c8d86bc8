"""fairseq-compatible symbol dictionary.

Index layout must bit-match the reference (tasks/mm_tasks/segmentation.py:109-136,
tasks/ofa_task.py:96-119): specials <s>=0 <pad>=1 </s>=2 <unk>=3, then dict.txt
entries (GPT-2 id strings) from index 4, then <mask>, <code_0..code_dict_size-1>,
<bin_0..num_bins-1>, <seg_0..num_seg_tokens> (num_seg_tokens + 1 seg symbols; the
last one is the "unknown" class). Checkpoint vocab surgery depends on these exact
indices.
"""

from typing import List, Optional

import numpy as np


class Dictionary:
    def __init__(self, bos="<s>", pad="<pad>", eos="</s>", unk="<unk>"):
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices = {}
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        self.nspecial = len(self.symbols)

    def __len__(self):
        return len(self.symbols)

    def __contains__(self, sym):
        return sym in self.indices

    def __getitem__(self, idx):
        if idx < len(self.symbols):
            return self.symbols[idx]
        return "<unk>"

    def add_symbol(self, word, n=1):
        if word in self.indices:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    def index(self, sym):
        return self.indices.get(sym, self.unk_index)

    def bos(self):
        return self.bos_index

    def pad(self):
        return self.pad_index

    def eos(self):
        return self.eos_index

    def unk(self):
        return self.unk_index

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        d = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                idx = line.rfind(" ")
                if idx == -1:
                    word, cnt = line, 1
                else:
                    word, cnt = line[:idx], int(line[idx + 1 :])
                d.add_symbol(word, cnt)
        return d

    def encode_line(self, line: str, append_eos: bool = False) -> np.ndarray:
        """Whitespace-split symbols -> indices (fairseq Dictionary.encode_line with
        add_if_not_exist=False)."""
        words = line.split()
        ids = [self.index(w) for w in words]
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int64)


def build_seg_dictionary(
    bpe_dir: str,
    code_dict_size: int = 8192,
    num_bins: int = 1000,
    num_seg_tokens: Optional[int] = None,
) -> Dictionary:
    """Reference dict construction: base dict.txt + <mask> + codes + bins (+ segs).

    Reference: tasks/ofa_task.py:96-119 and tasks/mm_tasks/segmentation.py:109-136.
    """
    import os

    d = Dictionary.load(os.path.join(bpe_dir, "dict.txt"))
    d.add_symbol("<mask>")
    for i in range(code_dict_size):
        d.add_symbol(f"<code_{i}>")
    for i in range(num_bins):
        d.add_symbol(f"<bin_{i}>")
    if num_seg_tokens is not None:
        for i in range(num_seg_tokens + 1):
            d.add_symbol(f"<seg_{i}>")
    return d
