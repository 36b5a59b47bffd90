"""PartSetHeader, BlockID, CommitSig and Commit: what commit verification
reads (a subset of tendermint_tpu/types/block.py).

Reference parity: types/block.go (CommitSig:452, Commit:556, BlockID:893).
Times are integer unix nanoseconds throughout (deterministic, no tz).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..encoding.proto import field_bytes, field_varint
from . import canonical
from .params import MAX_SIGNATURE_SIZE, MAX_VOTES_COUNT

ADDRESS_SIZE = 20
HASH_SIZE = 32

# BlockIDFlag (types/block.go:442-449)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


def validate_hash(h: bytes) -> None:
    """Hashes are either empty or tmhash-sized (types/validation.go:32)."""
    if h and len(h) != HASH_SIZE:
        raise ValueError(f"expected size to be {HASH_SIZE} bytes, got {len(h)} bytes")


@dataclass(frozen=True)
class PartSetHeader:
    """types/part_set.go:59."""

    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        validate_hash(self.hash)

    def encode(self) -> bytes:
        return field_varint(1, self.total) + field_bytes(2, self.hash)

    def __str__(self) -> str:
        return f"{self.total}:{self.hash.hex()[:12]}"


@dataclass(frozen=True)
class BlockID:
    """types/block.go:893."""

    hash: bytes = b""
    parts_header: PartSetHeader = field(default_factory=PartSetHeader)

    def key(self) -> bytes:
        """Machine-readable identity (types/block.go:905)."""
        return self.hash + self.parts_header.encode()

    def is_zero(self) -> bool:
        return len(self.hash) == 0 and self.parts_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == HASH_SIZE
            and self.parts_header.total > 0
            and len(self.parts_header.hash) == HASH_SIZE
        )

    def validate_basic(self) -> None:
        validate_hash(self.hash)
        self.parts_header.validate_basic()

    def __str__(self) -> str:
        return f"{self.hash.hex()[:12]}:{self.parts_header}"


@dataclass(frozen=True)
class CommitSig:
    """One validator's slot in a Commit (types/block.go:452)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_ABSENT, b"", 0, b"")

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig signed over (types/block.go:497)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present")
            if self.timestamp_ns != 0:
                raise ValueError("time is present")
            if self.signature:
                raise ValueError("signature is present")
        else:
            if len(self.validator_address) != ADDRESS_SIZE:
                raise ValueError(
                    f"expected ValidatorAddress size {ADDRESS_SIZE}, got {len(self.validator_address)}"
                )
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")


class Commit:
    """Proof a block was committed: ordered CommitSigs (types/block.go:556).

    Signature order matches validator-set order, so the batch verifier can
    gather pubkeys by index — no per-sig address lookups.
    """

    def __init__(self, height: int, round_: int, block_id: BlockID, signatures: List[CommitSig]):
        self.height = height
        self.round = round_
        self.block_id = block_id
        self.signatures = signatures

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, val_idx: int, pub_key=None) -> bytes:
        """Sign-bytes for slot val_idx (types/block.go:621) — only the
        timestamp differs between validators.  `pub_key` keeps the JAX
        package's signature; this slice carries ed25519 keys only, which
        all sign the timestamped layout."""
        cs = self.signatures[val_idx]
        bid = cs.block_id(self.block_id)
        return canonical.canonical_vote_sign_bytes(
            chain_id,
            canonical.PRECOMMIT_TYPE,
            self.height,
            self.round,
            bid.hash,
            bid.parts_header.total,
            bid.parts_header.hash,
            cs.timestamp_ns,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.block_id.is_zero():
            raise ValueError("commit cannot be for nil block")
        if not self.signatures:
            raise ValueError("no signatures in commit")
        if len(self.signatures) > MAX_VOTES_COUNT:
            raise ValueError("too many signatures")
        for i, cs in enumerate(self.signatures):
            try:
                cs.validate_basic()
            except ValueError as e:
                raise ValueError(f"wrong CommitSig #{i}: {e}") from e

    def __repr__(self) -> str:
        return f"Commit(H={self.height} R={self.round} sigs={len(self.signatures)})"
