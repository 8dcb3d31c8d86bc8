"""The port's evaluation rows against the JAX package's, field by field and
bit for bit: ``FileDataset`` (slicing, the shared ``<file>.index.json``
cache, a cache gone stale), ``SegmentationDataset.get_eval_sample`` over
``tests/utils.py:make_seg_tsv`` TSVs, and the SHA-256 digests of the rows of
``chip_smoke.py``'s validate phase, which that script holds on the card.
"""

import json
import os
import tempfile

import numpy as np
import pytest

import chip_smoke
from ifseg_torch.config import TaskConfig as TorchTaskConfig
from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.data import file_dataset as tfd
from ifseg_torch.data.segmentation_dataset import SegmentationDataset as TorchDataset
from ifseg_torch.tasks.segmentation import SegmentationTask as TorchTask
from ifseg_torch.tokenization.dictionary import build_seg_dictionary as torch_dict
from ifseg_torch.tokenization.gpt2_bpe import GPT2BPE as TorchBPE
from ifseg_tpu.config import TaskConfig as JaxTaskConfig
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.data import file_dataset as jfd
from ifseg_tpu.data.segmentation_dataset import SegmentationDataset as JaxDataset
from ifseg_tpu.tasks.segmentation import SegmentationTask as JaxTask
from ifseg_tpu.tokenization.dictionary import build_seg_dictionary as jax_dict
from ifseg_tpu.tokenization.gpt2_bpe import GPT2BPE as JaxBPE

from utils import make_seg_tsv

FIELDS = ("patch_image", "src_tokens", "bos_token", "ori_semantic_seg")


def _rows(path):
    return [line.rstrip("\n").split("\t") for line in open(path)]


@pytest.mark.parametrize("total,count", [(10, 1), (10, 3), (7, 4), (3, 5)])
def test_file_dataset_slices_equal_jax(tmp_path, total, count):
    path = make_seg_tsv(str(tmp_path / "d.tsv"), rows=total, size=(32, 24), seed=total)
    for i in range(count):
        got = tfd.FileDataset(path, "0,1,2", slice_id=i, slice_count=count)
        want = jfd.FileDataset(path, "0,1,2", slice_id=i, slice_count=count)
        assert (got.start_pos, got.row_count, len(got)) == (want.start_pos, want.row_count, len(want))
        assert [got[j] for j in range(len(got))] == [want[j] for j in range(len(want))]
    default = tfd.FileDataset(path, "0,2")
    assert (default.slice_id, default.slice_count, len(default)) == (0, 1, total)
    assert default[total - 1] == [_rows(path)[-1][0], _rows(path)[-1][2]]
    default.set_total_row_count(total // 2)
    assert len(default) == total // 2
    with pytest.raises(IndexError):
        default[total // 2]


def test_index_cache_is_shared_and_rebuilt_when_stale(tmp_path):
    path = make_seg_tsv(str(tmp_path / "d.tsv"), rows=5, size=(32, 24), seed=1)
    cache = path + ".index.json"
    got = tfd.FileDataset(path, "0,1,2")
    payload = json.load(open(cache))
    assert set(payload) == {"size", "mtime", "offsets"} and len(payload["offsets"]) == 5
    # the JAX package reads the port's cache as its own, and the other way round
    assert jfd.FileDataset(path, "0,1,2", slice_id=0, slice_count=1).lineid_to_offset == got.lineid_to_offset
    os.remove(cache)
    jfd.FileDataset(path, "0,1,2", slice_id=0, slice_count=1)
    assert tfd.FileDataset(path, "0,1,2").lineid_to_offset == payload["offsets"]
    # the TSV is written again with other rows: the stamp no longer matches
    make_seg_tsv(path, rows=7, size=(40, 36), seed=2)
    os.utime(path, (payload["mtime"] + 10, payload["mtime"] + 10))
    fresh = tfd.FileDataset(path, "0,1,2")
    assert len(fresh) == 7 and json.load(open(cache))["size"] == os.stat(path).st_size
    want = jfd.FileDataset(path, "0,1,2", slice_id=0, slice_count=1)
    assert [fresh[j] for j in range(7)] == [want[j] for j in range(7)] == _rows(path)
    # uncached: the same offsets
    assert tfd.FileDataset(path, "0,1,2", cached_index=False).lineid_to_offset == fresh.lineid_to_offset


@pytest.mark.parametrize("size", [(96, 80), (512, 683), (300, 200), (40, 1200), (1024, 1366)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_eval_samples_equal_jax(tmp_path, bpe_dir, size):
    path = make_seg_tsv(str(tmp_path / "d.tsv"), rows=2, num_seg=3, size=size, seed=sum(size))
    kw = dict(num_seg_tokens=3, category_list="cat, dog, grass", patch_image_size=512,
              bpe_dir=bpe_dir)
    want = JaxDataset("valid", jfd.FileDataset(path, "0,1,2", slice_id=0, slice_count=1), JaxBPE.from_dir(bpe_dir),
                      jax_dict(bpe_dir, num_seg_tokens=3), JaxTaskConfig(**kw))
    got = TorchDataset("valid", tfd.FileDataset(path, "0,1,2"), TorchBPE.from_dir(bpe_dir),
                       torch_dict(bpe_dir, num_seg_tokens=3), TorchTaskConfig(**kw))
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got.get_eval_sample(i), want.get_eval_sample(i)
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert g.ori_shape == w.ori_shape and g.id == w.id


def test_chip_smoke_rows_match_their_pil_cv2_digests():
    """The digests ``chip_smoke.py`` holds the card machine's decode and
    resize to: what the JAX package's pipeline (PIL, cv2) gives for the rows
    of its seeded TSV, and what the port gives."""
    with tempfile.TemporaryDirectory() as tmp:
        tsv = chip_smoke.write_valid_tsv(os.path.join(tmp, "validation.tsv"))
        argv = chip_smoke.ade_argv(tsv, os.path.join(tmp, "unused.pt"))
        want = JaxTask.setup_task(jax_flags(argv)).load_dataset("valid")
        got = TorchTask.setup_task(torch_flags(argv)).load_dataset("valid")
        assert len(got) == len(want) == chip_smoke.VALID_ROWS
        assert len(got.src_item) == chip_smoke.VALID_SRC_LEN
        for i in range(chip_smoke.VALID_ROWS):
            w, g = want.get_eval_sample(i), got.get_eval_sample(i)
            digests = [(chip_smoke.row_digest(s.patch_image),
                        chip_smoke.row_digest(s.ori_semantic_seg)) for s in (w, g)]
            assert digests[0] == digests[1] == chip_smoke.VALID_DIGESTS[i], i
