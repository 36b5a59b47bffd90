"""PartSet: blocks split into merkle-proven 64 KiB parts for gossip (the
port's copy of tendermint_tpu/types/part_set.py).

Reference parity: types/part_set.go (Part:22, PartSet:91,
NewPartSetFromData:100, AddPart:186).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..crypto import merkle
from ..encoding import codec
from ..libs.bitarray import BitArray
from .block import PartSetHeader
from .params import BLOCK_PART_SIZE_BYTES


class PartSetError(Exception):
    pass


@dataclass(frozen=True)
class Part:
    index: int
    bytes: bytes
    proof: merkle.SimpleProof = field(default_factory=lambda: merkle.SimpleProof(0, 0, b""))

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative Index")
        if len(self.bytes) > BLOCK_PART_SIZE_BYTES:
            raise ValueError(f"too big: {len(self.bytes)} bytes, max: {BLOCK_PART_SIZE_BYTES}")

    def to_dict(self) -> dict:
        return {"index": self.index, "bytes": self.bytes, "proof": self.proof.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "Part":
        return cls(d["index"], d["bytes"], merkle.SimpleProof.from_dict(d["proof"]))


codec.register("tm/Part")(Part)


class PartSet:
    def __init__(self, total: int, hash_: bytes):
        self.total = total
        self._hash = hash_
        self.parts: List[Optional[Part]] = [None] * total
        self.parts_bit_array = BitArray(total)
        self.count = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """Immutable full set: split into part_size chunks + merkle proofs
        (types/part_set.go:100)."""
        total = max(1, (len(data) + part_size - 1) // part_size)
        chunks = [data[i * part_size : (i + 1) * part_size] for i in range(total)]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(total, root)
        for i, chunk in enumerate(chunks):
            ps.parts[i] = Part(i, chunk, proofs[i])
            ps.parts_bit_array.set_index(i, True)
        ps.count = total
        return ps

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        """Empty set awaiting gossiped parts (types/part_set.go:129)."""
        return cls(header.total, header.hash)

    def header(self) -> PartSetHeader:
        return PartSetHeader(self.total, self._hash)

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header() == header

    def hash(self) -> bytes:
        return self._hash

    def hashes_to(self, h: bytes) -> bool:
        return self._hash == h

    def bit_array(self) -> BitArray:
        return self.parts_bit_array.copy()

    def add_part(self, part: Part) -> bool:
        """types/part_set.go:186.  False for duplicates; raises on invalid
        index or proof."""
        if part.index < 0 or part.index >= self.total:
            raise PartSetError("unexpected part index")
        if self.parts[part.index] is not None:
            return False
        if not part.proof.verify(self._hash, part.bytes):
            raise PartSetError("invalid part proof")
        self.parts[part.index] = part
        self.parts_bit_array.set_index(part.index, True)
        self.count += 1
        return True

    def get_part(self, index: int) -> Optional[Part]:
        if index < 0 or index >= self.total:
            return None
        return self.parts[index]

    def is_complete(self) -> bool:
        return self.count == self.total

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise PartSetError("cannot assemble incomplete PartSet")
        return b"".join(p.bytes for p in self.parts)

    def __repr__(self) -> str:
        return f"PartSet({self.count} of {self.total})"
