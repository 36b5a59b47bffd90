"""Trusted store: persisted (SignedHeader, ValidatorSet) pairs (the port's
copy of tendermint_tpu/lite2/store.py).

Reference parity: lite2/store/store.go (interface), store/db (tm-db
backed).  Keys are zero-padded heights so lexicographic order equals
numeric order (same trick as store/db/db.go).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..encoding import codec
from ..types.block import SignedHeader
from ..types.validator import ValidatorSet


class LightStore:
    def save_signed_header_and_validator_set(
        self, sh: SignedHeader, vals: ValidatorSet
    ) -> None:
        raise NotImplementedError

    def delete(self, height: int) -> None:
        raise NotImplementedError

    def signed_header(self, height: int) -> Optional[SignedHeader]:
        raise NotImplementedError

    def validator_set(self, height: int) -> Optional[ValidatorSet]:
        raise NotImplementedError

    def latest_height(self) -> int:
        raise NotImplementedError

    def first_height(self) -> int:
        raise NotImplementedError

    def heights(self) -> List[int]:
        """Descending (store/store.go SignedHeaderAfter ordering helpers)."""
        raise NotImplementedError

    def latest(self) -> Optional[Tuple[SignedHeader, ValidatorSet]]:
        h = self.latest_height()
        if h == 0:
            return None
        return self.signed_header(h), self.validator_set(h)


class MemStore(LightStore):
    def __init__(self):
        self._data: dict = {}

    def save_signed_header_and_validator_set(self, sh, vals) -> None:
        self._data[sh.height] = (sh, vals)

    def delete(self, height: int) -> None:
        self._data.pop(height, None)

    def signed_header(self, height: int):
        e = self._data.get(height)
        return e[0] if e else None

    def validator_set(self, height: int):
        e = self._data.get(height)
        return e[1] if e else None

    def latest_height(self) -> int:
        return max(self._data) if self._data else 0

    def first_height(self) -> int:
        return min(self._data) if self._data else 0

    def heights(self) -> List[int]:
        return sorted(self._data, reverse=True)


class DBStore(LightStore):
    """lite2/store/db — persisted via the framework's kv backend."""

    def __init__(self, db):
        self.db = db

    @staticmethod
    def _k(prefix: bytes, height: int) -> bytes:
        return prefix + b"%020d" % height

    def save_signed_header_and_validator_set(self, sh, vals) -> None:
        self.db.write_batch(
            [
                (self._k(b"sh/", sh.height), codec.dumps(sh)),
                (self._k(b"vs/", sh.height), codec.dumps(vals)),
            ]
        )

    def delete(self, height: int) -> None:
        self.db.delete(self._k(b"sh/", height))
        self.db.delete(self._k(b"vs/", height))

    def signed_header(self, height: int):
        raw = self.db.get(self._k(b"sh/", height))
        return codec.loads(raw) if raw else None

    def validator_set(self, height: int):
        raw = self.db.get(self._k(b"vs/", height))
        return codec.loads(raw) if raw else None

    def heights(self) -> List[int]:
        out = []
        for k, _ in self.db.iterate_prefix(b"sh/"):
            out.append(int(k[len(b"sh/"):]))
        return sorted(out, reverse=True)

    def latest_height(self) -> int:
        hs = self.heights()
        return hs[0] if hs else 0

    def first_height(self) -> int:
        hs = self.heights()
        return hs[-1] if hs else 0
