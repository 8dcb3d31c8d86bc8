"""The shared-memory feed (``ifseg_torch/data/shm_feed.py``): batches in
order, equal to the thread backend's through ``EpochBatchIterator``, and a
worker's failure raised by ``get`` instead of a hang (a ``make_batch`` that
raises, and a worker that dies without a word)."""

import os
import time

import numpy as np
import pytest

from ifseg_torch.data.iterators import EpochBatchIterator
from ifseg_torch.data.shm_feed import ShmBatchFeed, WorkerError


def _batch(i):
    rng = np.random.default_rng(i)
    return {"x": rng.normal(size=(3, 4)).astype(np.float32),
            "y": np.full((2,), i, np.int64), "m": rng.random(5) > 0.5}


def test_feed_returns_every_batch_in_order():
    n = 7
    feed = ShmBatchFeed(lambda i: _batch(i) if i < n else None, _batch(0), num_workers=3)
    try:
        for i in range(n):
            got = feed.get(timeout=30)
            for k, v in _batch(i).items():
                np.testing.assert_array_equal(got[k], v)
        with pytest.raises(StopIteration):
            feed.get(timeout=30)
    finally:
        feed.close()


def _iterator(feed, workers):
    def make_example(i, rng):
        return {"row": np.full((3,), i, np.int64), "noise": rng.normal(size=(2, 2))}

    def collate(examples):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}

    return EpochBatchIterator(11, 3, make_example, collate, seed=4, epoch=2,
                              num_workers=workers, row_offset=5, feed=feed)


def test_shm_batches_equal_the_thread_backends():
    want = list(_iterator("thread", 2).next_epoch_itr())
    itr = _iterator("shm", 2)
    got = list(itr.next_epoch_itr())
    itr.close()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _raising(i):
    if i == 2:
        raise ValueError("corrupt row 2")
    return _batch(i)


def test_a_raising_worker_makes_get_raise():
    feed = ShmBatchFeed(_raising, _batch(0), num_workers=2)
    try:
        feed.get(timeout=30)
        feed.get(timeout=30)
        with pytest.raises(WorkerError, match="corrupt row 2"):
            feed.get(timeout=30)
    finally:
        feed.close()


def _dying(i):
    if i == 1:
        os._exit(3)
    return _batch(i)


def test_a_dead_worker_makes_get_raise_not_hang():
    feed = ShmBatchFeed(_dying, _batch(0), num_workers=2)
    t0 = time.monotonic()
    try:
        feed.get(timeout=30)
        with pytest.raises(WorkerError, match="died"):
            feed.get(timeout=30)
    finally:
        feed.close()
    assert time.monotonic() - t0 < 20
