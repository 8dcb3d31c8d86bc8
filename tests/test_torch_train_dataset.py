"""The port's training rows and batches against the JAX package's, to the
byte: ``SegmentationDataset("train", ...).get_train_example`` on the rows of
a ``tests/utils.py:make_seg_tsv`` TSV with generators of the same seed
(the decoding path with the whole augmentation chain, and the image-free
fast path that never decodes), and ``collate_train``'s ``SegBatch``.
"""

import numpy as np
import pytest

from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.tasks.segmentation import SegmentationTask as TorchTask
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.tasks.segmentation import SegmentationTask as JaxTask

from utils import make_seg_tsv
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

FIELDS = ("patch_images", "src_tokens", "bos_tokens", "target", "downsampled_target",
          "aux_grid_ids", "aux_target", "ids")


def _argv(tsv, bpe_dir, size, *extra):
    return [f"{tsv},{tsv}", "--num-seg-tokens=3", "--category-list=cat, dog, grass",
            f"--patch-image-size={size}", f"--orig-patch-image-size={size}",
            f"--bpe-dir={bpe_dir}", *extra]


def _train_sets(argv):
    tasks = [T.setup_task(f(argv)) for T, f in ((TorchTask, torch_flags), (JaxTask, jax_flags))]
    return [t.load_dataset("train") for t in tasks]


@pytest.mark.parametrize("size,rows", [(64, (96, 80)), (32, (300, 260)), (128, (75, 140))])
def test_train_examples_equal_jax(tmp_path, bpe_dir, size, rows):
    """Up- and down-scales, crops with retries, flips and the colour jitter:
    every field of every row equal, and the generators in the same state
    afterwards."""
    tsv = make_seg_tsv(str(tmp_path / "train.tsv"), rows=4, num_seg=3, size=rows, seed=size)
    got_ds, want_ds = _train_sets(_argv(tsv, bpe_dir, size))
    assert not got_ds.skip_real_images and np.array_equal(got_ds.src_item, want_ds.src_item)
    for i in range(len(want_ds)):
        for seed in range(6):
            ga, gb = np.random.default_rng((7, seed, i)), np.random.default_rng((7, seed, i))
            got, want = got_ds.get_train_example(i, ga), want_ds.get_train_example(i, gb)
            assert got.keys() == want.keys()
            for k in want:
                if k == "id":
                    assert got[k] == want[k]
                else:
                    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            assert got["patch_image"].shape == (size, size, 3)
            assert ga.bit_generator.state == gb.bit_generator.state


def test_fast_path_examples_equal_jax_and_decode_nothing(tmp_path, bpe_dir, monkeypatch):
    tsv = make_seg_tsv(str(tmp_path / "train.tsv"), rows=3, num_seg=3, seed=1)
    got_ds, want_ds = _train_sets(_argv(tsv, bpe_dir, 64, "--decode-real-images=false"))
    assert got_ds.skip_real_images and want_ds.skip_real_images
    monkeypatch.setattr(type(got_ds), "_decode_row", lambda *a: pytest.fail("decoded a row"))
    for i in range(len(want_ds)):
        got = got_ds.get_train_example(i, np.random.default_rng(i))
        want = want_ds.get_train_example(i, np.random.default_rng(i))
        assert got.keys() == want.keys() == {"id", "aux_grid_ids", "aux_target"}
        assert got["id"] == want["id"]
        assert np.array_equal(got["aux_grid_ids"], want["aux_grid_ids"])
        assert np.array_equal(got["aux_target"], want["aux_target"])


@pytest.mark.parametrize("fast", [False, True], ids=["decoded", "image-free"])
def test_collate_train_equals_jax(tmp_path, bpe_dir, fast):
    tsv = make_seg_tsv(str(tmp_path / "train.tsv"), rows=3, num_seg=3, seed=2)
    extra = ["--decode-real-images=false"] if fast else []
    got_ds, want_ds = _train_sets(_argv(tsv, bpe_dir, 64, *extra))
    got = got_ds.collate_train([got_ds.get_train_example(i, np.random.default_rng(i))
                                for i in range(3)])
    want = want_ds.collate_train([want_ds.get_train_example(i, np.random.default_rng(i))
                                  for i in range(3)])
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, k
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (got.nsentences, got.ntokens) == (want.nsentences, want.ntokens)
    assert got.ntokens == 3 * (64 * 64 + 1)
    assert got.aux_target.dtype == np.uint8 and got.aux_grid_ids.dtype == np.int32
    if not fast:
        assert got.patch_images.dtype == np.uint8 and got.target.dtype == np.uint8
        assert got.patch_images.shape == (3, 64, 64, 3)
