"""Vote: sign-bytes and the CommitSig a precommit becomes (a subset of
tendermint_tpu/types/vote.py, enough to build commits).

Reference parity: types/vote.go (Vote:48, CommitSig:60).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import canonical
from .block import BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL, BlockID, CommitSig


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
