"""The port's ``EpochBatchIterator`` against the JAX package's: the same
batches from the same ``make_example``, ``len``, ``state_dict`` and a
mid-epoch resume; batches equal for 0 and 3 row workers (also through the
task on a real TSV); ``close`` leaves no thread alive; a row that fails
raises in the consumer.
"""

import threading

import numpy as np
import pytest

from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.data.iterators import EpochBatchIterator as TorchIterator
from ifseg_torch.tasks.segmentation import SegmentationTask as TorchTask
from ifseg_tpu.data.iterators import EpochBatchIterator as JaxIterator

from utils import make_seg_tsv


def make_example(i, rng):
    return {"i": i, "x": rng.integers(0, 1 << 30, size=5)}


def collate(examples):
    return {"i": np.asarray([e["i"] for e in examples]), "x": np.stack([e["x"] for e in examples])}


def _take(itr):
    return [(b["i"].tolist(), b["x"].tolist()) for b in itr]


@pytest.mark.parametrize("rows,batch", [(10, 3), (12, 4), (7, 7), (5, 6)])
def test_batches_len_and_state_equal_jax(rows, batch):
    kw = dict(num_rows=rows, batch_size=batch, make_example=make_example, collate=collate,
              seed=5, epoch=2, row_offset=100)
    got, want = TorchIterator(**kw), JaxIterator(**kw)
    assert len(got) == len(want) == rows // batch
    for _ in range(2):  # this epoch and the next
        assert _take(got.next_epoch_itr()) == _take(want.next_epoch_itr())
        assert got.state_dict() == want.state_dict()
        assert got.end_of_epoch and want.end_of_epoch
    got.close()


def test_mid_epoch_resume_equals_jax_and_an_unbroken_epoch():
    kw = dict(num_rows=20, batch_size=4, make_example=make_example, collate=collate, seed=3)
    whole = _take(TorchIterator(**kw).next_epoch_itr())
    first = TorchIterator(**kw)
    itr = first.next_epoch_itr()
    head = _take([next(itr), next(itr)])
    state = first.state_dict()
    first.close()
    assert state == {"epoch": 1, "iterations_in_epoch": 2, "seed": 3}
    got, want = TorchIterator(**kw), JaxIterator(**kw)
    got.load_state_dict(state)
    want.load_state_dict(state)
    tail = _take(got.next_epoch_itr())
    assert head + tail == whole and tail == _take(want.next_epoch_itr())
    # a cursor at the end of the epoch rolls to the next one
    end = TorchIterator(**kw)
    end.load_state_dict({"epoch": 1, "iterations_in_epoch": 5, "seed": 3})
    assert end.epoch == 2 and end.iterations_in_epoch == 0
    got.close()


def test_row_workers_give_equal_batches_on_a_tsv(tmp_path, bpe_dir):
    tsv = make_seg_tsv(str(tmp_path / "train.tsv"), rows=8, num_seg=3, seed=4)
    batches = []
    for workers in (0, 3):
        cfg = torch_flags([f"{tsv},{tsv}", "--num-seg-tokens=3", "--category-list=cat, dog, grass",
                           "--patch-image-size=64", f"--bpe-dir={bpe_dir}",
                           f"--num-workers={workers}"])
        task = TorchTask.setup_task(cfg)
        task.load_dataset("train")
        itr = task.get_batch_iterator("train", batch_size=3, seed=7, epoch=1)
        batches.append(list(itr.next_epoch_itr()))
        itr.close()
    assert len(batches[0]) == len(batches[1]) == 2
    for a, b in zip(*batches):
        for k in ("patch_images", "target", "downsampled_target", "aux_grid_ids", "aux_target",
                  "ids"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    # evaluation rows go through the Evaluator, not a batch iterator
    task.load_dataset("valid")
    with pytest.raises(ValueError, match="only the train split"):
        task.get_batch_iterator("valid", batch_size=1)


@pytest.mark.parametrize("workers", [0, 3])
def test_close_leaves_no_thread_alive(workers):
    before = set(threading.enumerate())
    itr = TorchIterator(num_rows=400, batch_size=2, make_example=make_example, collate=collate,
                        buffer_size=1, num_workers=workers)
    epoch = itr.next_epoch_itr()
    next(epoch)  # the producer is now blocked on the full queue
    itr.close()
    assert not epoch._thread.is_alive()
    assert [t for t in threading.enumerate() if t not in before] == []
    # and again after rolling over, with a resumed epoch in flight
    itr.next_epoch_itr()
    itr.close()
    assert [t for t in threading.enumerate() if t not in before] == []


def test_a_failing_row_raises_in_the_consumer():
    def bad(i, rng):
        if i == 5:
            raise ValueError("corrupt row 5")
        return make_example(i, rng)

    itr = TorchIterator(num_rows=8, batch_size=2, make_example=bad, collate=collate)
    epoch = itr.next_epoch_itr()
    assert [b["i"].tolist() for b in (next(epoch), next(epoch))] == [[0, 1], [2, 3]]
    with pytest.raises(RuntimeError, match="training batch") as info:
        next(epoch)
    assert "corrupt row 5" in str(info.value.__cause__)
    assert not epoch._thread.is_alive()
