"""Multi-process data feed over shared memory (the JAX package's
``data/shm_feed.py``).

The reference's analog is the Arrow plasma store (data/plasma_utils.py,
opt-in ``--use-plasma-view``) plus num_workers dataloader processes: the
augmentation work leaves the training process without pickling arrays
through pipes.  N worker processes run ``make_batch`` and publish
fixed-shape batches into per-worker rings of
``multiprocessing.shared_memory`` blocks; the consumer maps them without a
copy.

Worker w owns its own slot ring and builds batches w, w+N, w+2N, ...; the
consumer reads batches in order, which visits the workers round-robin, so a
worker's slots recycle in a fixed order and one worker's lead can never
exhaust another's ring.

A worker whose ``make_batch`` raises sends its traceback, and ``get``
raises it in the consumer when it reaches that batch; a worker that dies
without a word (killed, out of memory) is noticed while ``get`` waits,
which then raises too: no error leaves the consumer waiting.

    feed = ShmBatchFeed(make_batch, template_batch, num_workers=4)
    for step in range(n):
        batch = feed.get()   # dict of numpy views into shared memory
        ...
    feed.close()
"""

import logging
import multiprocessing as mp
import queue
import time
import traceback
from multiprocessing import shared_memory
from typing import Any, Callable, Dict, List

import numpy as np

logger = logging.getLogger(__name__)

_POLL_S = 0.5  # how often a waiting ``get`` looks at its workers


def _batch_layout(template: Dict[str, np.ndarray]):
    layout = {}
    offset = 0
    for k in sorted(template):
        v = np.asarray(template[k])
        layout[k] = (offset, v.shape, v.dtype.str)
        offset += v.nbytes
    return layout, offset


def _worker(make_batch, layout, shm_names, free_q, ready_q, start, step):
    shms = [shared_memory.SharedMemory(name=n) for n in shm_names]
    idx = start
    try:
        while True:
            slot = free_q.get()
            if slot is None:
                break
            try:
                batch = make_batch(idx)
            except BaseException:
                ready_q.put(("error", idx, traceback.format_exc()))
                break
            if batch is None:
                ready_q.put(None)
                break
            buf = shms[slot].buf
            for k, (off, shape, dtype) in layout.items():
                arr = np.ndarray(shape, dtype, buffer=buf, offset=off)
                np.copyto(arr, np.asarray(batch[k]))
            ready_q.put((idx, slot))
            idx += step
    finally:
        for s in shms:
            s.close()


class WorkerError(RuntimeError):
    """A feed worker failed: its traceback, or that it died."""


class ShmBatchFeed:
    def __init__(
        self,
        make_batch: Callable[[int], Dict[str, np.ndarray]],
        template: Dict[str, np.ndarray],
        num_workers: int = 2,
        slots_per_worker: int = 2,
        ctx: str = "fork",
    ):
        self.layout, self.nbytes = _batch_layout(template)
        self.num_workers = num_workers
        mpc = mp.get_context(ctx)
        self._ready: Any = mpc.Queue()
        self._shms: List[shared_memory.SharedMemory] = []
        self._frees: List[Any] = []
        self._procs: List[Any] = []
        self._slot_owner: Dict[int, int] = {}
        slot_id = 0
        for w in range(num_workers):
            free_q = mpc.Queue()
            for _ in range(slots_per_worker):
                shm = shared_memory.SharedMemory(create=True, size=max(self.nbytes, 1))
                self._shms.append(shm)
                free_q.put(slot_id)
                self._slot_owner[slot_id] = w
                slot_id += 1
            self._frees.append(free_q)
        # each worker addresses slots by their global id, so it gets every name
        all_names = [s.name for s in self._shms]
        for w in range(num_workers):
            p = mpc.Process(
                target=_worker,
                args=(make_batch, self.layout, all_names, self._frees[w],
                      self._ready, w, num_workers),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        self._pending: Dict[int, int] = {}
        self._next = 0
        self._inflight_slot = None
        self._done_workers = 0

    def _next_item(self, deadline: float):
        """The next message of the workers; raises where a worker died
        without one or the wait passes ``deadline``."""
        while True:
            try:
                return self._ready.get(timeout=_POLL_S)
            except queue.Empty:
                pass
            dead = [w for w, p in enumerate(self._procs) if p.exitcode not in (None, 0)]
            if dead:
                raise WorkerError(f"feed worker(s) {dead} died (exit codes "
                                  f"{[self._procs[w].exitcode for w in dead]})")
            if time.monotonic() > deadline:
                raise TimeoutError("no batch from the feed workers")

    def get(self, timeout: float = 300.0):
        """Next batch IN ORDER as numpy views (valid until the next get())."""
        if self._inflight_slot is not None:
            owner = self._slot_owner[self._inflight_slot]
            self._frees[owner].put(self._inflight_slot)
            self._inflight_slot = None
        deadline = time.monotonic() + timeout
        while self._next not in self._pending:
            item = self._next_item(deadline)
            if item is None:
                self._done_workers += 1
                if (
                    self._done_workers >= self.num_workers
                    and self._next not in self._pending
                ):
                    raise StopIteration
                continue
            if item[0] == "error":  # raised when the consumer reaches that batch
                self._pending[item[1]] = item
                continue
            idx, slot = item
            self._pending[idx] = slot
        slot = self._pending.pop(self._next)
        if isinstance(slot, tuple):
            raise WorkerError(f"feed worker failed on batch {slot[1]}:\n{slot[2]}")
        self._next += 1
        self._inflight_slot = slot
        buf = self._shms[slot].buf
        return {
            k: np.ndarray(shape, dtype, buffer=buf, offset=off)
            for k, (off, shape, dtype) in self.layout.items()
        }

    def close(self):
        for q in self._frees:
            try:
                q.put(None)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for s in self._shms:
            try:
                s.close()
                s.unlink()
            except Exception:
                pass
