"""Result cursors: server-side response store with paged fetch.

Reference parity: pinot-spi ResponseStore + broker cursor endpoints
(pinot-broker/.../broker/cursors/, CursorIntegrationTest) — a query run
with cursors enabled keeps its full result server-side; clients page
through it by cursor id.  Copy of pinot_tpu/query/cursors.py (host-only).
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, Optional

from pinot_tpu_torch.query.result import ResultTable


class ResponseStore:
    def __init__(self, ttl_seconds: float = 300.0, max_entries: int = 128):
        self.ttl = ttl_seconds
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._store: Dict[str, tuple] = {}  # id -> (ResultTable, page_size, created)

    def register(self, result: ResultTable, page_size: int = 1000) -> str:
        cid = uuid.uuid4().hex[:16]
        with self._lock:
            self._evict_locked()
            # monotonic: TTL age math must not jump with wall-clock steps
            self._store[cid] = (result, max(1, page_size), time.monotonic())
        return cid

    def fetch(self, cursor_id: str, page: int) -> Dict:
        with self._lock:
            self._evict_locked()  # TTL applies on read too, not just register
            entry = self._store.get(cursor_id)
        if entry is None:
            raise KeyError(f"cursor {cursor_id!r} not found (expired or never created)")
        result, page_size, _ = entry
        n = len(result.rows)
        start = page * page_size
        rows = result.rows[start : start + page_size]
        return {
            "cursorId": cursor_id,
            "page": page,
            "pageSize": page_size,
            "totalRows": n,
            "numPages": (n + page_size - 1) // page_size,
            "columns": result.columns,
            "rows": [list(r) for r in rows],
        }

    def delete(self, cursor_id: str) -> bool:
        with self._lock:
            return self._store.pop(cursor_id, None) is not None

    def _evict_locked(self) -> None:
        now = time.monotonic()
        dead = [cid for cid, (_, _, t) in self._store.items() if now - t > self.ttl]
        for cid in dead:
            del self._store[cid]
        while len(self._store) >= self.max_entries:
            oldest = min(self._store, key=lambda c: self._store[c][2])
            del self._store[oldest]
