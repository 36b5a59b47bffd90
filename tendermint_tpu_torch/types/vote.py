"""Vote type + errors (a copy of tendermint_tpu/types/vote.py).

Reference parity: types/vote.go (Vote:48, CommitSig:60, Verify:124,
ValidateBasic:136).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..encoding import codec
from . import canonical
from .block import ADDRESS_SIZE, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL, BlockID, CommitSig
from .params import MAX_SIGNATURE_SIZE


class VoteError(Exception):
    pass


def is_bls_key(pub_key) -> bool:
    """True for BLS12-381 keys."""
    return getattr(pub_key, "TYPE", None) == "tendermint/PubKeyBLS12381"


class ErrVoteConflictingVotes(VoteError):
    """Raised by VoteSet on double-sign; carries the evidence
    (types/vote.go:29)."""

    def __init__(self, evidence):
        self.evidence = evidence
        super().__init__(f"conflicting votes from validator {evidence.vote_a.validator_address.hex()}")


@dataclass
class Vote:
    """A prevote or precommit (types/vote.go:48)."""

    type: int = 0
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    timestamp_ns: int = 0
    validator_address: bytes = b""
    validator_index: int = -1
    signature: bytes = b""
    # Encode-once caches (gossip hot path): a signed vote is immutable, so
    # its canonical codec bytes, and the consensus reactor's single-vote
    # frame, are computed once and reused across every peer send.  Excluded
    # from equality/repr; never serialized.
    _wire: Optional[bytes] = field(default=None, repr=False, compare=False)
    _legacy_frame: Optional[bytes] = field(default=None, repr=False, compare=False)

    def wire(self) -> bytes:
        """Canonical tagged codec encoding ('@t' form), cached.  vote_batch
        frames embed these bytes verbatim."""
        if self._wire is None:
            self._wire = codec.dumps(self)
        return self._wire

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.canonical_vote_sign_bytes(
            chain_id,
            self.type,
            self.height,
            self.round,
            self.block_id.hash,
            self.block_id.parts_header.total,
            self.block_id.parts_header.hash,
            self.timestamp_ns,
        )

    def bls_sign_bytes(self, chain_id: str) -> bytes:
        """Timestamp-free sign-bytes — the message BLS validators sign so
        that every precommit for one block is aggregatable into a single
        pairing check (canonical.canonical_vote_sign_bytes_no_ts)."""
        return canonical.canonical_vote_sign_bytes_no_ts(
            chain_id,
            self.type,
            self.height,
            self.round,
            self.block_id.hash,
            self.block_id.parts_header.total,
            self.block_id.parts_header.hash,
        )

    def sign_bytes_for_key(self, chain_id: str, pub_key) -> bytes:
        """Per-scheme sign-bytes routing: BLS validators sign (and are
        verified against) the timestamp-free domain; every other key type
        keeps the reference layout."""
        if is_bls_key(pub_key):
            return self.bls_sign_bytes(chain_id)
        return self.sign_bytes(chain_id)

    def commit_sig(self) -> CommitSig:
        """types/vote.go:60."""
        if self.block_id.is_complete():
            flag = BLOCK_ID_FLAG_COMMIT
        elif self.block_id.is_zero():
            flag = BLOCK_ID_FLAG_NIL
        else:
            raise ValueError(f"invalid vote {self} - BlockID must be empty or complete")
        return CommitSig(
            block_id_flag=flag,
            validator_address=self.validator_address,
            timestamp_ns=self.timestamp_ns,
            signature=self.signature,
        )

    def verify(self, chain_id: str, pub_key) -> None:
        """Single-vote host verification (types/vote.go:124).  Vote ingress
        verifies through crypto.batch_verifier instead."""
        if pub_key.address() != self.validator_address:
            raise VoteError("invalid validator address")
        if not pub_key.verify(self.sign_bytes_for_key(chain_id, pub_key), self.signature):
            raise VoteError("invalid signature")

    def validate_basic(self) -> None:
        if not canonical.is_vote_type_valid(self.type):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.block_id.validate_basic()
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got {self.block_id}")
        if len(self.validator_address) != ADDRESS_SIZE:
            raise ValueError(
                f"expected ValidatorAddress size {ADDRESS_SIZE}, got {len(self.validator_address)}"
            )
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def copy(self) -> "Vote":
        return Vote(
            self.type,
            self.height,
            self.round,
            self.block_id,
            self.timestamp_ns,
            self.validator_address,
            self.validator_index,
            self.signature,
        )

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "height": self.height,
            "round": self.round,
            "block_id": self.block_id.to_dict(),
            "timestamp_ns": self.timestamp_ns,
            "validator_address": self.validator_address,
            "validator_index": self.validator_index,
            "signature": self.signature,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Vote":
        return cls(
            type=d["type"],
            height=d["height"],
            round=d["round"],
            block_id=BlockID.from_dict(d["block_id"]),
            timestamp_ns=d["timestamp_ns"],
            validator_address=d["validator_address"],
            validator_index=d["validator_index"],
            signature=d["signature"],
        )

    def __str__(self) -> str:
        tname = {canonical.PREVOTE_TYPE: "Prevote", canonical.PRECOMMIT_TYPE: "Precommit"}.get(
            self.type, "?"
        )
        return (
            f"Vote{{{self.validator_index}:{self.validator_address.hex()[:12]} "
            f"{self.height}/{self.round:02d}/{tname} {self.block_id.hash.hex()[:12]}}}"
        )


codec.register("tm/Vote")(Vote)
