"""Evidence of validator misbehaviour: DuplicateVoteEvidence with its wire
bytes and hash, and the evidence list's merkle root (the port's copy of
tendermint_tpu/types/evidence.py, ed25519 votes only).

Reference parity: types/evidence.go (Evidence iface:59,
DuplicateVoteEvidence:101, EvidenceList:320).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

from ..crypto import merkle, tmhash
from ..crypto.keys import pubkey_from_dict
from ..encoding import codec


class Evidence(ABC):
    @abstractmethod
    def height(self) -> int: ...

    @abstractmethod
    def time_ns(self) -> int: ...

    @abstractmethod
    def address(self) -> bytes: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    @abstractmethod
    def verify(self, chain_id: str, pub_key) -> None: ...

    @abstractmethod
    def validate_basic(self) -> None: ...

    def equal(self, other: "Evidence") -> bool:
        return type(self) is type(other) and self.hash() == other.hash()

    def __eq__(self, other) -> bool:
        return isinstance(other, Evidence) and self.equal(other)

    def __hash__(self) -> int:
        return hash(self.hash())


@codec.register("tm/DuplicateVoteEvidence")
class DuplicateVoteEvidence(Evidence):
    """A validator signed two conflicting votes (types/evidence.go:101)."""

    def __init__(self, pub_key, vote_a, vote_b):
        self.pub_key = pub_key
        self.vote_a = vote_a
        self.vote_b = vote_b

    @classmethod
    def from_votes(cls, pub_key, vote1, vote2) -> Optional["DuplicateVoteEvidence"]:
        """Orders the two votes by block key (types/evidence.go:110)."""
        if vote1 is None or vote2 is None:
            return None
        if vote1.block_id.key() <= vote2.block_id.key():
            return cls(pub_key, vote1, vote2)
        return cls(pub_key, vote2, vote1)

    def height(self) -> int:
        return self.vote_a.height

    def time_ns(self) -> int:
        return self.vote_a.timestamp_ns

    def address(self) -> bytes:
        return self.pub_key.address()

    def bytes(self) -> bytes:
        return codec.dumps(self.to_dict())

    def verify(self, chain_id: str, pub_key) -> None:
        """types/evidence.go:166 — same H/R/S + validator, different blocks,
        both signatures valid."""
        a, b = self.vote_a, self.vote_b
        if a.height != b.height or a.round != b.round or a.type != b.type:
            raise ValueError(f"H/R/S does not match: {a} vs {b}")
        if a.validator_address != b.validator_address:
            raise ValueError("validator addresses do not match")
        if a.validator_index != b.validator_index:
            raise ValueError("validator indices do not match")
        if a.block_id == b.block_id:
            raise ValueError("blockIDs are the same - not a real duplicate vote")
        if pub_key.address() != a.validator_address:
            raise ValueError("address does not match pubkey")
        # per-scheme sign-bytes: BLS votes sign the timestamp-free domain,
        # and a BLS equivocation is two DIFFERENT messages (block ids
        # differ), so the evidence stays meaningful without timestamps
        if not pub_key.verify(a.sign_bytes_for_key(chain_id, pub_key), a.signature):
            raise ValueError("invalid signature on VoteA")
        if not pub_key.verify(b.sign_bytes_for_key(chain_id, pub_key), b.signature):
            raise ValueError("invalid signature on VoteB")

    def validate_basic(self) -> None:
        if not self.pub_key.bytes():
            raise ValueError("empty PubKey")
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("one or both of the votes are empty")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    def to_dict(self) -> dict:
        return {
            "pub_key": self.pub_key.to_dict(),
            "vote_a": self.vote_a.to_dict(),
            "vote_b": self.vote_b.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DuplicateVoteEvidence":
        from .vote import Vote

        return cls(
            pubkey_from_dict(d["pub_key"]), Vote.from_dict(d["vote_a"]), Vote.from_dict(d["vote_b"])
        )

    def __repr__(self) -> str:
        return f"DuplicateVoteEvidence(VoteA: {self.vote_a}; VoteB: {self.vote_b})"


def evidence_list_hash(evl: List[Evidence]) -> bytes:
    """Merkle root of the evidence list (types/evidence.go:324)."""
    return merkle.hash_from_byte_slices([ev.bytes() for ev in evl])


def evidence_hash(ev: Evidence) -> bytes:
    return ev.hash()
