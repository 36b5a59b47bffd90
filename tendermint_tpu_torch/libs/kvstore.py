"""Embedded key-value store abstraction (the port's copy of
tendermint_tpu/libs/kvstore.py: the same table and pragmas, so either
package opens the other's files).

Counterpart of the reference's tm-db dependency (goleveldb et al. behind
`dbm.DB`): ordered byte-keyed store with batched atomic writes and prefix
iteration.  Two backends: in-memory (tests, like tm-db memdb) and SQLite
(durable; ships with CPython, no external deps allowed in this image).
"""

from __future__ import annotations

import bisect
import os
import sqlite3
import threading
from abc import ABC, abstractmethod
from typing import Dict, Iterator, List, Optional, Tuple


class KVStore(ABC):
    @abstractmethod
    def get(self, key: bytes) -> Optional[bytes]: ...

    @abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Ordered iteration over keys starting with prefix."""

    @abstractmethod
    def write_batch(self, sets: List[Tuple[bytes, bytes]], deletes: List[bytes] = ()) -> None:
        """Atomic multi-write."""

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def close(self) -> None:
        pass


class MemDB(KVStore):
    """Sorted in-memory store (reference memdb equivalent)."""

    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._delete_locked(key)

    def _delete_locked(self, key: bytes) -> None:
        if key in self._data:
            del self._data[key]
            idx = bisect.bisect_left(self._keys, key)
            if idx < len(self._keys) and self._keys[idx] == key:
                self._keys.pop(idx)

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            start = bisect.bisect_left(self._keys, prefix)
            snapshot = []
            for i in range(start, len(self._keys)):
                k = self._keys[i]
                if not k.startswith(prefix):
                    break
                snapshot.append((k, self._data[k]))
        yield from snapshot

    def write_batch(self, sets, deletes=()) -> None:
        # materialize + copy BEFORE mutating: an iterable that raises (or a
        # value that fails bytes()) mid-batch must leave the store exactly
        # as it was — write_batch promises all-or-nothing
        staged = [(k, bytes(v)) for k, v in sets]
        staged_deletes = list(deletes)
        with self._lock:
            for k, v in staged:
                if k not in self._data:
                    bisect.insort(self._keys, k)
                self._data[k] = v
            for k in staged_deletes:
                self._delete_locked(k)


class SQLiteDB(KVStore):
    """Durable backend over sqlite3 with WAL journaling."""

    def __init__(self, path: str):
        self.path = path  # storage_info / debug bundles report per-store usage
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute("CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
            self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def _rollback(self) -> None:
        """Best-effort rollback after a failed write: without it the NEXT
        commit (any later set) would flush the half-applied statements —
        a crashed batch observed half-applied later."""
        try:
            self._conn.rollback()
        except sqlite3.Error:
            pass

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            try:
                self._conn.execute("INSERT OR REPLACE INTO kv VALUES (?, ?)", (key, value))
                self._conn.commit()
            except BaseException:
                self._rollback()
                raise

    def delete(self, key: bytes) -> None:
        with self._lock:
            try:
                self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
                self._conn.commit()
            except BaseException:
                self._rollback()
                raise

    @staticmethod
    def _prefix_upper_bound(prefix: bytes) -> Optional[bytes]:
        """Smallest byte string greater than every key with this prefix, or
        None when the prefix is all 0xff (no upper bound exists)."""
        p = bytearray(prefix)
        while p:
            if p[-1] != 0xFF:
                p[-1] += 1
                return bytes(p)
            p.pop()
        return None

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        hi = self._prefix_upper_bound(prefix)
        with self._lock:
            if hi is None:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (prefix,)
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k", (prefix, hi)
                ).fetchall()
        for k, v in rows:
            if bytes(k).startswith(prefix):
                yield bytes(k), bytes(v)

    def write_batch(self, sets, deletes=()) -> None:
        # atomicity across a crash: every statement inside ONE transaction,
        # explicit rollback on ANY failure (incl. injected fsync/commit
        # errors) — a batch must never be observable half-applied
        staged = list(sets)
        staged_deletes = [(k,) for k in deletes]
        with self._lock:
            try:
                self._conn.executemany("INSERT OR REPLACE INTO kv VALUES (?, ?)", staged)
                if staged_deletes:
                    self._conn.executemany("DELETE FROM kv WHERE k = ?", staged_deletes)
                self._conn.commit()
            except BaseException:
                self._rollback()
                raise

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def open_db(name: str, home: Optional[str] = None, backend: str = "sqlite") -> KVStore:
    """DBProvider equivalent (node/node.go:62): named DBs under home/data."""
    if backend == "memdb" or home is None:
        return MemDB()
    return SQLiteDB(os.path.join(home, "data", f"{name}.db"))
