"""Seekable TSV dataset with a cached offset index and process sharding.

Capability parity with the reference `data/file_dataset.py`:
  - newline-offset index built once and cached as ``<file>.index.json``
    (stamped with the source's size+mtime; stale caches rebuild) with a
    ``.working`` rendezvous flag so only one process sweeps the file
    (ref :53-84)
  - contiguous rank slicing: each process owns ``total // world`` rows with the
    first ``total % world`` processes taking one extra (ref :97-103)
  - ``total_row_count`` override for epoch row caps
    (tasks/mm_tasks/segmentation.py:150-153)

A copy of the JAX package's ``data/file_dataset.py``, with the same
``<file>.index.json`` cache (format and name), so both packages can share a
TSV and its index.  The slice of a process is given by the caller
(``slice_id``/``slice_count``, 0 and 1 by default) where the JAX package asks
``jax.process_index()``.  The index is JSON (no pickle trust issues), and
reads are positioned ``os.pread`` calls: stateless, so workers and prefetch
threads share the descriptor without offset races.
"""

import json
import logging
import os
import time
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)


def _build_offsets(file_path: str) -> List[int]:
    offsets = []
    offset = 0
    with open(file_path, "rb") as fp:
        for line in fp:
            offsets.append(offset)
            offset += len(line)
    return offsets


class FileDataset:
    def __init__(
        self,
        file_path: str,
        selected_col_ids: Optional[str] = None,
        separator: str = "\t",
        cached_index: bool = True,
        slice_id: int = 0,
        slice_count: int = 1,
    ):
        if not os.path.exists(file_path):
            raise FileNotFoundError(f"The local datafile {file_path} does not exist")
        self.file_path = file_path
        self.separator = separator
        if selected_col_ids is None:
            with open(file_path) as fp:
                ncols = len(fp.readline().rstrip("\n").split(separator))
            self.selected_col_ids = list(range(ncols))
        else:
            self.selected_col_ids = [int(c) for c in selected_col_ids.split(",")]

        self.slice_id = slice_id
        self.slice_count = slice_count

        self._init_seek_index(cached_index)
        self._fd = os.open(self.file_path, os.O_RDONLY)
        self._compute_start_pos_and_row_count()
        logger.info(
            "file %s slice_id %d row count %d total row count %d",
            file_path, self.slice_id, self.row_count, self.total_row_count,
        )

    # ------------------------------------------------------------------ index

    def _init_seek_index(self, cached: bool) -> None:
        if not cached:
            self.lineid_to_offset = _build_offsets(self.file_path)
            self.total_row_count = len(self.lineid_to_offset)
            return
        cache_path = f"{self.file_path}.index.json"
        working = Path(f"{cache_path}.working")
        is_master = self.slice_id == 0
        st = os.stat(self.file_path)
        stamp = {"size": st.st_size, "mtime": st.st_mtime}

        def _read_valid():
            """Offsets if the cache exists AND matches the source file's
            size+mtime stamp (a regenerated TSV must invalidate the index —
            stale offsets read garbage mid-row)."""
            try:
                with open(cache_path) as fp:
                    payload = json.load(fp)
            except (json.JSONDecodeError, OSError, FileNotFoundError):
                return None
            if (
                not isinstance(payload, dict)
                or payload.get("size") != stamp["size"]
                or payload.get("mtime") != stamp["mtime"]
            ):
                return None  # legacy bare-list format or stale — rebuild
            return payload["offsets"]

        deadline = time.time() + 600
        offsets = _read_valid()
        while offsets is None:
            if is_master:
                try:
                    working.touch()
                    built = _build_offsets(self.file_path)
                    with open(working, "w") as fp:
                        json.dump({**stamp, "offsets": built}, fp)
                    working.rename(cache_path)
                except OSError:
                    pass
            offsets = _read_valid()
            if offsets is not None:
                break
            if time.time() > deadline:
                raise TimeoutError(f"timed out waiting for index {cache_path}")
            time.sleep(1)
        self.lineid_to_offset = offsets
        self.total_row_count = len(self.lineid_to_offset)

    def _compute_start_pos_and_row_count(self) -> None:
        """Contiguous slice per process (ref file_dataset.py:97-103)."""
        total, n, i = self.total_row_count, self.slice_count, self.slice_id
        self.row_count = total // n
        if i < total - self.row_count * n:
            self.row_count += 1
            self.start_pos = self.row_count * i
        else:
            self.start_pos = self.row_count * i + (total - self.row_count * n)

    def set_total_row_count(self, n: int) -> None:
        """Epoch row cap (tasks/mm_tasks/segmentation.py:150-153)."""
        self.total_row_count = min(n, len(self.lineid_to_offset))
        self._compute_start_pos_and_row_count()

    def get_total_row_count(self) -> int:
        return self.total_row_count

    # ----------------------------------------------------------------- access

    def __len__(self) -> int:
        return self.row_count

    def __getitem__(self, index: int) -> List[str]:
        if not 0 <= index < self.row_count:
            raise IndexError(index)
        # positioned read (os.pread): no shared seek state, so forked shm
        # workers and concurrent prefetch threads can read the same open
        # file descriptor without racing on the kernel file offset (a
        # seek()+readline() pair is NOT atomic across processes)
        row = self.start_pos + index
        off = self.lineid_to_offset[row]
        if row + 1 < len(self.lineid_to_offset):
            length = self.lineid_to_offset[row + 1] - off
        else:
            length = os.fstat(self._fd).st_size - off
        data = os.pread(self._fd, length, off)
        cols = data.decode("utf-8").rstrip("\n").split(self.separator)
        return [cols[c] for c in self.selected_col_ids]

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fd"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._fd = os.open(self.file_path, os.O_RDONLY)
