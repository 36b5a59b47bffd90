"""Trusted store: persisted (SignedHeader, ValidatorSet) pairs.  The
port's copy of the store interface and the in-memory store of
tendermint_tpu/lite2/store.py; the database-backed store goes through a
codec the port does not have yet.

Reference parity: lite2/store/store.go (interface).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
