"""Disk-backed FIFO queue (util/DiskBasedQueue.java, 205 LoC).

The reference spills queued items to one file per element under a temp dir
so unbounded producer queues don't exhaust the heap (used by the NLP vocab
pipeline). Same design: pickle per element, FIFO by monotonically increasing
file index, thread-safe, iterable-drainable. Port of
``deeplearning4j_tpu/utils/diskqueue.py``."""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
from typing import Any, Iterator, Optional


class DiskBasedQueue:
    def __init__(self, dir_path: Optional[str] = None):
        self._dir = dir_path or tempfile.mkdtemp(prefix="dl4j-queue-")
        os.makedirs(self._dir, exist_ok=True)
        self._lock = threading.Lock()
        self._head = 0  # next index to pop
        self._tail = 0  # next index to write

    def _path(self, i: int) -> str:
        return os.path.join(self._dir, f"{i:012d}.pkl")

    def add(self, item: Any) -> None:
        if item is None:
            raise ValueError("None cannot be queued (poll's empty sentinel)")
        # serialize outside the lock; claim the index AND publish the file
        # under it, so poll can never reserve an index whose file is missing
        fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            idx = self._tail
            os.replace(tmp, self._path(idx))
            self._tail += 1

    def poll(self) -> Optional[Any]:
        """Pop the oldest item; None when empty (Queue.poll semantics)."""
        with self._lock:
            if self._head >= self._tail:
                return None
            idx = self._head
            self._head += 1
        path = self._path(idx)
        with open(path, "rb") as f:
            item = pickle.load(f)
        os.unlink(path)
        return item

    def size(self) -> int:
        with self._lock:
            return self._tail - self._head

    def is_empty(self) -> bool:
        return self.size() == 0

    def drain(self) -> Iterator[Any]:
        while True:
            item = self.poll()
            if item is None:
                return
            yield item

    def close(self) -> None:
        with self._lock:
            for i in range(self._head, self._tail):
                try:
                    os.unlink(self._path(i))
                except FileNotFoundError:
                    pass
            self._head = self._tail
        try:
            os.rmdir(self._dir)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
