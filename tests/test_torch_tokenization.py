"""The port's tokenization against the JAX package's: the dictionary, the
GPT-2 BPE (whose pre-tokenizer the port writes without the ``regex``
package), WordPiece, and the category prompt of the reference run scripts.

Everything here is integer ids or strings: equal, never close.
"""

import re
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import regex
from hypothesis import example, given, settings
from hypothesis import strategies as st

from ifseg_torch.config import TaskConfig as TorchTaskConfig
from ifseg_torch.data.segmentation_dataset import SegmentationDataset as TorchDataset
from ifseg_torch.tokenization import bert_bpe as tbert
from ifseg_torch.tokenization import dictionary as tdict
from ifseg_torch.tokenization import gpt2_bpe as tgpt2
from ifseg_tpu.config import TaskConfig as JaxTaskConfig
from ifseg_tpu.data.segmentation_dataset import SegmentationDataset as JaxDataset
from ifseg_tpu.tokenization import bert_bpe as jbert
from ifseg_tpu.tokenization import dictionary as jdict
from ifseg_tpu.tokenization import gpt2_bpe as jgpt2
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

REPO = Path(__file__).resolve().parents[1]
PATTERN = regex.compile(jgpt2._GPT2_PATTERN)


@pytest.fixture(scope="module")
def bpes(bpe_dir):
    return jgpt2.GPT2BPE.from_dir(bpe_dir), tgpt2.GPT2BPE.from_dir(bpe_dir)


def _script(name):
    text = (REPO / "run_scripts" / "IFSeg" / f"{name}.sh").read_text()
    cats = re.search(r"export category_list='([^']*)'", text).group(1)
    n = int(re.search(r"export num_seg_tokens=(\d+)", text).group(1))
    return cats, n


# (run script, length of its source sequence: bos + prompt + class names + 'unknown' + eos)
SCRIPTS = [("ade", 215), ("coco_unseen", 36), ("coco_fine", 239)]


@pytest.mark.parametrize("name,length", SCRIPTS, ids=[s for s, _ in SCRIPTS])
def test_category_prompt_equals_jax(bpe_dir, bpes, name, length):
    cats, n = _script(name)
    jbpe, tbpe = bpes
    jd = jdict.build_seg_dictionary(bpe_dir, num_seg_tokens=n)
    td = tdict.build_seg_dictionary(bpe_dir, num_seg_tokens=n)
    assert td.symbols == jd.symbols and td.indices == jd.indices
    kw = dict(num_seg_tokens=n, category_list=cats, bpe_dir=bpe_dir)
    want = JaxDataset("valid", None, jbpe, jd, JaxTaskConfig(**kw))
    got = TorchDataset("valid", None, tbpe, td, TorchTaskConfig(**kw))
    assert got.src_item.dtype == want.src_item.dtype
    np.testing.assert_array_equal(got.src_item, want.src_item)
    np.testing.assert_array_equal(got.class_tokens, want.class_tokens)
    np.testing.assert_array_equal(got.class_lengths, want.class_lengths)
    assert len(got.src_item) == length
    assert got.class_tokens.shape[0] == n + 1


def test_training_split_equals_jax(bpe_dir, bpes):
    """The training split's prompt and class table are the JAX package's,
    and it carries the training transforms, not the evaluation resize."""
    cats, n = _script("coco_unseen")
    kw = dict(num_seg_tokens=n, category_list=cats, bpe_dir=bpe_dir)
    got = TorchDataset("train", None, bpes[1], tdict.build_seg_dictionary(bpe_dir, num_seg_tokens=n),
                       TorchTaskConfig(**kw))
    want = JaxDataset("train", None, bpes[0], jdict.build_seg_dictionary(bpe_dir, num_seg_tokens=n),
                      JaxTaskConfig(**kw))
    np.testing.assert_array_equal(got.src_item, want.src_item)
    np.testing.assert_array_equal(got.class_tokens, want.class_tokens)
    assert not hasattr(got, "eval_resize") and got.crop.crop_size == want.crop.crop_size


ALPHABETS = [
    st.characters(min_codepoint=0x20, max_codepoint=0x7E),  # printable ASCII
    st.characters(min_codepoint=0xA0, max_codepoint=0xFF),  # Latin-1
    st.characters(min_codepoint=0x4E00, max_codepoint=0x4E80),  # CJK
    st.sampled_from("0123456789²³¹¼½¾٣६०Ⅻ"),  # digits, No, Nl
    st.sampled_from(".,;:!?'\"-_()[]{}@#$%^&*/\\|~`+=<>"),  # punctuation
    st.sampled_from(" \t\n\r\x0b\x0c\x1c\x1d\x1e\x1f\x85\xa0  　"),  # whitespace
    st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "  ", "\n\n", " \n"]),
]


@settings(max_examples=400, deadline=None)
@given(st.lists(st.one_of(*ALPHABETS), max_size=40).map("".join))
@example("Hello world's  a\n\n b  ")
@example("   trailing spaces   ")
@example(" \t\n x")  # \s+(?!\S) backs off one character before 'x'
@example("it's 12.5 km!! ''s 'S")
@example("\x1c a \x1d")  # not \s for regex, although str.isspace
def test_pretokenizer_equals_regex(text):
    assert tgpt2.pretokenize(text) == PATTERN.findall(text)


def test_whitespace_class_equals_regex_everywhere():
    space = regex.compile(r"\s")
    for cp in range(0x110000):
        c = chr(cp)
        assert (tgpt2._kind(c) == "S") == bool(space.match(c)), hex(cp)


def test_letter_and_number_classes_equal_regex_on_every_code_point():
    """The pre-tokenizer's letter and number classes are ``regex``'s on all
    0x110000 code points, including those this Python's ``unicodedata``
    leaves unassigned and ``regex``'s newer Unicode assigns (the port's
    table ``_NEWER_LN``)."""
    letter, number = regex.compile(r"\p{L}"), regex.compile(r"\p{N}")
    differ = []
    for cp in range(0x110000):
        c = chr(cp)
        k = tgpt2._kind(c)
        if (k == "L") != bool(letter.match(c)) or (k == "N") != bool(number.match(c)):
            differ.append(cp)
    assert differ == []
    assert any(unicodedata.category(chr(first)) == "Cn" for first, _, _ in tgpt2._NEWER_LN)


@pytest.mark.parametrize("text", [
    "what is the segmentation map of the image? object:",
    " chest of drawers", " café résumé naïve", " 中文 字符 ", "x  y\t\tz\n", " 1234 5.6e7",
    " don't we'll they've I'm", " emoji 🙂 and ½",
    # letters and numbers of a Unicode newer than Python 3.12's: Egyptian
    # hieroglyphs of U+13460.., Kirat Rai digits U+16D70.., U+0C5C, U+A7CB
    " \U00013460\U00013461x 12\U00016D70\U00016D71 \u0c5c\ua7cb!",
])
def test_gpt2_bpe_equals_jax(bpes, text):
    jbpe, tbpe = bpes
    assert tbpe.encode(text) == jbpe.encode(text)
    assert tbpe.decode(tbpe.encode(text)) == jbpe.decode(jbpe.encode(text))


BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "sat", "mat", "on",
              "a", "##s", "##ting", "sit", "un", "##aff", "##able", "你", "好", ",", "!", "?",
              ".", "'", "s", "cafe", "don", "##t"]


@pytest.mark.parametrize("text", ["Hello, the CATS sitting unaffable 你好!", "café don't",
                                  "The cat sat on a mat.", "zzzz", "a" * 200, ""])
@pytest.mark.parametrize("cased", [False, True], ids=["uncased", "cased"])
def test_bert_bpe_equals_jax(tmp_path, text, cased):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(BERT_VOCAB), encoding="utf-8")
    want = jbert.BertBPE(str(vocab), cased=cased)
    got = tbert.BertBPE(str(vocab), cased=cased)
    assert got.encode(text) == want.encode(text)
    assert got.decode(got.encode(text)) == want.decode(want.encode(text))

