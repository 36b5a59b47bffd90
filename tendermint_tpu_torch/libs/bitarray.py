"""BitArray — vote-presence maps (a copy of
tendermint_tpu/libs/bitarray.py).

Counterpart of the reference's `libs/bits.BitArray`
(reference: libs/bits/bit_array.go), backed by a numpy bool vector.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

import numpy as np


class BitArray:
    __slots__ = ("bits", "_v")

    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bit count")
        self.bits = bits
        self._v = np.zeros(bits, dtype=bool)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_indices(cls, bits: int, indices: Iterable[int]) -> "BitArray":
        ba = cls(bits)
        for i in indices:
            ba.set_index(i, True)
        return ba

    @classmethod
    def from_numpy(cls, v: np.ndarray) -> "BitArray":
        ba = cls(int(v.shape[0]))
        ba._v = v.astype(bool).copy()
        return ba

    def copy(self) -> "BitArray":
        return BitArray.from_numpy(self._v)

    # -- element access ----------------------------------------------------
    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        return bool(self._v[i])

    def set_index(self, i: int, val: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        self._v[i] = val
        return True

    # -- set algebra (reference libs/bits/bit_array.go:116 Or/And/Not/Sub) --
    def or_(self, other: "BitArray") -> "BitArray":
        n = max(self.bits, other.bits)
        out = BitArray(n)
        out._v[: self.bits] |= self._v
        out._v[: other.bits] |= other._v
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        n = min(self.bits, other.bits)
        return BitArray.from_numpy(self._v[:n] & other._v[:n])

    def not_(self) -> "BitArray":
        return BitArray.from_numpy(~self._v)

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other."""
        out = self.copy()
        n = min(self.bits, other.bits)
        out._v[:n] &= ~other._v[:n]
        return out

    # -- queries -------------------------------------------------------------
    def is_empty(self) -> bool:
        return not self._v.any()

    def is_full(self) -> bool:
        return self.bits > 0 and bool(self._v.all())

    def count(self) -> int:
        return int(self._v.sum())

    def true_indices(self) -> list[int]:
        return [int(i) for i in np.nonzero(self._v)[0]]

    def pick_random(self, rng: Optional[random.Random] = None) -> Optional[int]:
        """A uniformly random set bit (reference bit_array.go:186 PickRandom)."""
        idx = np.nonzero(self._v)[0]
        if idx.size == 0:
            return None
        r = rng or random
        return int(idx[r.randrange(idx.size)])

    def as_numpy(self) -> np.ndarray:
        return self._v.copy()

    # -- serialization -------------------------------------------------------
    def to_bytes(self) -> bytes:
        return self.bits.to_bytes(4, "big") + np.packbits(self._v).tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BitArray":
        bits = int.from_bytes(data[:4], "big")
        v = np.unpackbits(np.frombuffer(data[4:], dtype=np.uint8))[:bits]
        return cls.from_numpy(v.astype(bool))

    # -- dunder --------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.bits == other.bits
            and bool(np.array_equal(self._v, other._v))
        )

    def __len__(self) -> int:
        return self.bits

    def __str__(self) -> str:
        return "".join("x" if b else "_" for b in self._v)

    def __repr__(self) -> str:
        return f"BitArray({self.bits}:{self})"
