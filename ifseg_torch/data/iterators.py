"""Resumable, prefetching epoch-batch iterator.

The port of the JAX package's ``data/iterators.py`` (fairseq's
EpochBatchIterator / CountingIterator / BufferedIterator as the OFA task's
sequential sampler uses them, reference tasks/ofa_task.py:120-165):
contiguous batches of rows in file order, no shuffling, the trailing short
batch dropped so every batch has the same shape, resumable at batch
granularity through ``state_dict`` / ``load_state_dict``.

Row ``i`` of epoch ``e`` draws from ``numpy.random.default_rng((seed, e,
row_offset + i))``, whatever thread builds it, so a batch does not depend on
the worker count or on a resume.  A background thread builds batches ahead
of the consumer (``buffer_size`` of them); with ``num_workers > 0`` it
builds each batch's rows on that many threads (decoding, resizing and the
colour conversions run mostly in zlib, the PNG unfilter and numpy, outside
the interpreter lock).  ``feed="shm"`` takes the JAX package's backend
instead: ``num_workers`` forked processes build whole batches into
shared-memory slots (``data/shm_feed.py``), the same batches in the same
order.  No CLI selects it yet: the JAX package turns it on with
``num_workers > 0``, which here means row threads, and the two backends
are not yet timed against each other on the card.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

_JOIN_TIMEOUT_S = 30.0


class EpochBatchIterator:
    def __init__(
        self,
        num_rows: int,
        batch_size: int,
        make_example: Callable,  # (index, rng) -> example
        collate: Callable,  # [examples] -> batch
        seed: int = 1,
        epoch: int = 1,
        buffer_size: int = 2,
        drop_last: bool = True,
        num_workers: int = 0,  # >0: threads that build a batch's rows
        row_offset: int = 0,  # global row index of local row 0
        feed: str = "thread",  # or "shm": num_workers processes build batches
    ):
        if feed not in ("thread", "shm") or (feed == "shm" and num_workers < 1):
            raise ValueError(f"feed {feed!r} with {num_workers} workers: take thread, or shm "
                             "with at least one worker")
        self.feed = feed
        self.num_rows = num_rows
        self.batch_size = batch_size
        self.make_example = make_example
        self.collate = collate
        self.seed = seed
        self.row_offset = row_offset
        self.epoch = max(epoch, 1)
        self.buffer_size = buffer_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._cur: Optional["_PrefetchIterator"] = None
        self._next_offset = 0

    def _make_example(self, epoch: int, i: int):
        return self.make_example(i, np.random.default_rng((self.seed, epoch, self.row_offset + i)))

    def _make_batch(self, epoch: int, b: int, pool: Optional[ThreadPoolExecutor] = None):
        """Batch ``b`` of ``epoch``, its rows built on ``pool`` when given."""
        lo = b * self.batch_size
        rows = range(lo, min(lo + self.batch_size, self.num_rows))
        if pool is None:
            examples = [self._make_example(epoch, i) for i in rows]
        else:
            examples = list(pool.map(lambda i: self._make_example(epoch, i), rows))
        return self.collate(examples)

    def __len__(self):
        if self.drop_last:
            return self.num_rows // self.batch_size
        return (self.num_rows + self.batch_size - 1) // self.batch_size

    @property
    def iterations_in_epoch(self) -> int:
        return self._cur.count if self._cur is not None else self._next_offset

    @property
    def end_of_epoch(self) -> bool:
        return self._cur is None or self._cur.exhausted

    def next_epoch_itr(self) -> Iterator:
        if self._cur is not None:
            if self._cur.exhausted:
                self.epoch += 1
                self._next_offset = 0
            else:  # resume the epoch in flight at its position
                self._next_offset = self._cur.count
            self._cur.close()
        # else: _next_offset holds a restored mid-epoch position (or 0)
        kind = _ShmIterator if self.feed == "shm" else _PrefetchIterator
        self._cur = kind(self, self.epoch, self._next_offset)
        return self._cur

    def close(self) -> None:
        """Stop the producer thread and its row workers."""
        if self._cur is not None:
            self._cur.close()

    def state_dict(self):
        return {
            "epoch": self.epoch,
            "iterations_in_epoch": self.iterations_in_epoch,
            "seed": self.seed,
        }

    def load_state_dict(self, state) -> None:
        self.epoch = state.get("epoch", 1)
        self.seed = state.get("seed", self.seed)
        it = state.get("iterations_in_epoch", 0)
        if it >= len(self):
            self.epoch += 1
            it = 0
        self._next_offset = it
        self._cur = None


class _PrefetchIterator:
    """Batches ``start_batch..`` of one epoch, built by a producer thread up
    to ``buffer_size`` ahead; a producer's exception is raised by
    ``__next__``."""

    def __init__(self, parent: EpochBatchIterator, epoch: int, start_batch: int):
        self.parent = parent
        self.epoch = epoch
        self.count = start_batch
        self.total = len(parent)
        self.exhausted = start_batch >= self.total
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(parent.buffer_size, 1))
        self._stop = threading.Event()
        self._pool = (ThreadPoolExecutor(parent.num_workers, thread_name_prefix="rows")
                      if parent.num_workers > 0 else None)
        self._thread = threading.Thread(target=self._produce, args=(start_batch,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, start_batch: int):
        try:
            for b in range(start_batch, self.total):
                if self._stop.is_set() or not self._put(
                        self.parent._make_batch(self.epoch, b, self._pool)):
                    return
        except Exception as e:  # a corrupt row: raised in the consumer
            self._put(e)
            return
        self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self.exhausted:
            raise StopIteration
        batch = self._queue.get()
        if isinstance(batch, Exception):
            self.close()
            raise RuntimeError("building a training batch failed") from batch
        if batch is None:
            self.exhausted = True
            raise StopIteration
        self.count += 1
        return batch

    def close(self):
        """Stop the producer (it may be blocked on a full queue or inside a
        batch) and wait for it and the row workers."""
        self._stop.set()
        self._thread.join(timeout=_JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            raise RuntimeError("the batch producer thread did not stop")
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def _to_array_dict(batch):
    """The numeric arrays of a batch (a dict or a ``SegBatch``-like
    dataclass), for the fixed-shape shared-memory slots."""
    items = batch.items() if isinstance(batch, dict) else vars(batch).items()
    out = {}
    for k, v in items:
        if v is None or not hasattr(v, "shape"):
            continue
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.number) or arr.dtype == bool:
            out[k] = arr
    return out


class _ShmIterator:
    """The shared-memory backend (``data/shm_feed.py``): the interface of
    ``_PrefetchIterator``, batches as dicts of the batch's arrays, copied
    out of their slots."""

    def __init__(self, parent: EpochBatchIterator, epoch: int, start_batch: int):
        from ifseg_torch.data.shm_feed import ShmBatchFeed

        self.count = start_batch
        self.total = len(parent)
        self.exhausted = start_batch >= self.total
        self._feed = None
        if self.exhausted:
            return
        template = _to_array_dict(parent._make_batch(epoch, start_batch))

        def make(i):
            b = start_batch + i
            return None if b >= self.total else _to_array_dict(parent._make_batch(epoch, b))

        self._feed = ShmBatchFeed(make, template, num_workers=parent.num_workers,
                                  slots_per_worker=max(parent.buffer_size, 2))

    def __iter__(self):
        return self

    def __next__(self):
        if self.exhausted:
            self.close()
            raise StopIteration
        try:
            batch = self._feed.get()
        except StopIteration:
            self.exhausted = True
            self.close()
            raise
        self.count += 1
        if self.count >= self.total:
            self.exhausted = True
        # out of the slot: the consumer may keep the batch past the slot's reuse
        return {k: v.copy() for k, v in batch.items()}

    def close(self):
        if self._feed is not None:
            self._feed.close()
            self._feed = None
