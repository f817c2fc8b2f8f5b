"""Session-keyed storage behind the UI server.

Port of ``deeplearning4j_tpu/ui/storage.py``, the reference UI's storage layer
(`deeplearning4j-ui/.../storage/SessionStorage.java` (162) and
`storage/HistoryStorage.java` (196)): the server keeps, per session id and
update type, the latest JSON snapshot plus a bounded history ring so the
dashboard can render both "now" and "over time" views without a database.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


class SessionStorage:
    """Latest snapshot per (session id, update type)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[Tuple[str, str], Any] = {}

    def put(self, sid: str, kind: str, payload: Any) -> None:
        with self._lock:
            self._data[(sid, kind)] = payload

    def get(self, sid: str, kind: str) -> Optional[Any]:
        with self._lock:
            return self._data.get((sid, kind))

    def sessions(self) -> List[str]:
        with self._lock:
            return sorted({sid for sid, _ in self._data})

    def kinds(self, sid: str) -> List[str]:
        with self._lock:
            return sorted({k for s, k in self._data if s == sid})


class HistoryStorage:
    """Bounded per-(sid, kind) history ring (HistoryStorage.java)."""

    def __init__(self, max_items: int = 512):
        self.max_items = max_items
        self._lock = threading.Lock()
        self._data: Dict[Tuple[str, str], deque] = {}

    def append(self, sid: str, kind: str, payload: Any) -> None:
        with self._lock:
            ring = self._data.setdefault(
                (sid, kind), deque(maxlen=self.max_items))
            ring.append({"t": time.time(), "payload": payload})

    def get(self, sid: str, kind: str, last: int = 0) -> List[Any]:
        with self._lock:
            ring = self._data.get((sid, kind))
            if ring is None:
                return []
            items = list(ring)
        return items[-last:] if last > 0 else items
