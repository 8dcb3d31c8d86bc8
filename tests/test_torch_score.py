"""``ifseg_torch.cli.score``, ``ifseg_torch.utils.scoring`` and
``ifseg_torch.benchmark.dummy_seg`` against the JAX package's modules.

  - the CLI prints the same lines as ``ifseg_tpu.cli.score`` for every
    metric (corpus and sentence BLEU, WER, ROUGE-L, CIDEr-D), orders 1 to 4,
    with and without ``--ignore-case``, on token files made from a seed, and
    exits with the same message on the same bad input;
  - ``corpus_bleu``, ``edit_distance``, ``wer``, ``rouge_l`` and ``cider_d``
    return what the JAX functions return (equal floats) under hypothesis;
  - ``dummy_seg_batch`` and ``DummySegTask`` give the JAX batch's keys,
    shapes and dtypes, with values in the JAX ranges, the same for the same
    generator seed.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import ifseg_tpu.benchmark.dummy_seg as jdummy
import ifseg_tpu.cli.score as jscore
import ifseg_tpu.utils.scoring as jscoring
from ifseg_tpu.config import Config as JaxConfig
from ifseg_torch.benchmark import dummy_seg as tdummy
from ifseg_torch.cli import score as tscore
from ifseg_torch.config import Config
from ifseg_torch.utils import scoring as tscoring

WORDS = ["the", "The", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "red", "Sky"]


def _write(path, rng, lines, jitter):
    """Token lines; with ``jitter`` the words of a reference line each kept
    with probability 0.7, swapped or extended."""
    with open(path, "w") as fp:
        for line in lines:
            words = list(line)
            if jitter:
                words = [w if rng.random() < 0.7 else str(rng.choice(WORDS)) for w in words]
                words += [str(rng.choice(WORDS)) for _ in range(rng.integers(0, 3))]
            fp.write(" ".join(words) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0)
    refs = [[str(w) for w in rng.choice(WORDS, size=rng.integers(0, 12))] for _ in range(25)]
    root = tmp_path_factory.mktemp("score")
    _write(root / "ref.txt", rng, refs, jitter=False)
    _write(root / "sys.txt", rng, refs, jitter=True)
    return str(root / "sys.txt"), str(root / "ref.txt")


ARGS = [[], ["--sentence-bleu"], ["--metric", "wer"], ["--metric", "rouge"],
        ["--metric", "cider"], ["-o", "2"], ["-o", "1", "--metric", "cider"], ["--ignore-case"],
        ["--ignore-case", "--sentence-bleu", "-o", "3"]]


@pytest.mark.parametrize("extra", ARGS, ids=[" ".join(a) or "bleu" for a in ARGS])
def test_cli_prints_the_jax_lines(extra, files, capsys):
    sysf, ref = files
    jscore.cli_main(["-s", sysf, "-r", ref] + extra)
    want = capsys.readouterr().out
    tscore.cli_main(["-s", sysf, "-r", ref] + extra)
    got = capsys.readouterr().out
    assert got == want and got


def test_cli_errors_are_the_jax_ones(files, tmp_path):
    sysf, ref = files
    short = tmp_path / "short.txt"
    short.write_text("one line\n")
    for argv in (["-s", sysf, "-r", str(tmp_path / "none.txt")],
                 ["-s", str(tmp_path / "none.txt"), "-r", ref], ["-s", str(short), "-r", ref]):
        with pytest.raises(SystemExit) as want:
            jscore.cli_main(argv)
        with pytest.raises(SystemExit) as got:
            tscore.cli_main(argv)
        assert str(got.value) == str(want.value)


tokens = st.lists(st.sampled_from(WORDS[:8]), max_size=14)


@settings(max_examples=150, deadline=None)
@given(pairs=st.lists(st.tuples(tokens, tokens), min_size=1, max_size=6),
       order=st.integers(1, 4), smooth=st.booleans())
def test_scoring_equals_jax(pairs, order, smooth):
    hyps, refs = [h for h, _ in pairs], [r for _, r in pairs]
    assert (tscoring.corpus_bleu(hyps, refs, max_order=order, smooth=smooth)
            == jscoring.corpus_bleu(hyps, refs, max_order=order, smooth=smooth))
    for h, r in pairs:
        assert tscoring.edit_distance(h, r) == jscoring.edit_distance(h, r)
        assert tscoring.wer(h, r) == jscoring.wer(h, r)
        assert tscoring.rouge_l(h, r) == jscoring.rouge_l(h, r)
    many = [[r, h[::-1]] for h, r in pairs]
    assert (tscoring.cider_d(hyps, many, max_order=order)
            == jscoring.cider_d(hyps, many, max_order=order))


def _cfgs(**model):
    jcfg, tcfg = JaxConfig(), Config()
    return (jcfg.replace(model=dataclasses.replace(jcfg.model, **model)),
            tcfg.replace(model=dataclasses.replace(tcfg.model, **model)))


@pytest.mark.parametrize("size,num_seg", [(64, 3), (96, 17)])
def test_dummy_batch_has_the_jax_keys_shapes_and_dtypes(size, num_seg):
    jcfg, tcfg = _cfgs(patch_image_size=size, num_seg_tokens=num_seg)
    want = jdummy.dummy_seg_batch(jcfg, batch_size=3, seed=1, src_len=20)
    gen = torch.Generator().manual_seed(1)
    got = tdummy.dummy_seg_batch(tcfg, 3, gen, device="cpu", src_len=20)
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == getattr(torch, str(v.dtype)), k
        assert got[k].device.type == "cpu"
    for k in ("target", "downsampled_target", "aux_grid_ids", "aux_target"):
        assert 0 <= int(got[k].min()) and int(got[k].max()) < num_seg
    assert 4 <= int(got["src_tokens"].min()) and int(got["src_tokens"].max()) < 1000
    assert not got["bos_tokens"].any()
    again = tdummy.dummy_seg_batch(tcfg, 3, torch.Generator().manual_seed(1), src_len=20)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_dummy_task_matches_the_jax_task():
    jcfg, tcfg = _cfgs(patch_image_size=64, num_seg_tokens=5)
    jtask, ttask = jdummy.DummySegTask(jcfg, src_len=12), tdummy.DummySegTask(tcfg, src_len=12)
    assert tuple(ttask.class_tokens.shape) == jtask.class_tokens.shape
    assert tuple(ttask.class_lengths.shape) == jtask.class_lengths.shape
    assert ttask.class_tokens.dtype == ttask.class_lengths.dtype == torch.int32
    jb, tb = list(jtask.batches(2, 4)), list(ttask.batches(2, 4))
    assert len(tb) == len(jb) == 2
    assert [{k: tuple(v.shape) for k, v in b.items()} for b in tb] == \
        [{k: v.shape for k, v in b.items()} for b in jb]
    assert not torch.equal(tb[0]["patch_images"], tb[1]["patch_images"])
