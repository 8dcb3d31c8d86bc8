from .gpt2_bpe import GPT2BPE
from .bert_bpe import BertBPE
from .dictionary import Dictionary, build_seg_dictionary

__all__ = ["GPT2BPE", "BertBPE", "Dictionary", "build_seg_dictionary"]
