"""Block proposal (the port's copy of tendermint_tpu/types/proposal.py).

Reference parity: types/proposal.go (Proposal:24, ValidateBasic:48,
SignBytes:93).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..encoding import codec
from . import canonical
from .block import BlockID
from .params import MAX_SIGNATURE_SIZE


@dataclass
class Proposal:
    height: int = 0
    round: int = 0
    pol_round: int = -1  # -1 if no proof-of-lock
    block_id: BlockID = field(default_factory=BlockID)
    timestamp_ns: int = 0
    signature: bytes = b""
    type: int = canonical.PROPOSAL_TYPE

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.canonical_proposal_sign_bytes(
            chain_id,
            self.height,
            self.round,
            self.pol_round,
            self.block_id.hash,
            self.block_id.parts_header.total,
            self.block_id.parts_header.hash,
            self.timestamp_ns,
        )

    def validate_basic(self) -> None:
        if self.type != canonical.PROPOSAL_TYPE:
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1:
            raise ValueError("negative POLRound (exception: -1)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError(f"expected a complete, non-empty BlockID, got {self.block_id}")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")

    def to_dict(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "pol_round": self.pol_round,
            "block_id": self.block_id.to_dict(),
            "timestamp_ns": self.timestamp_ns,
            "signature": self.signature,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Proposal":
        return cls(
            height=d["height"],
            round=d["round"],
            pol_round=d["pol_round"],
            block_id=BlockID.from_dict(d["block_id"]),
            timestamp_ns=d["timestamp_ns"],
            signature=d["signature"],
        )

    def __str__(self) -> str:
        return f"Proposal{{{self.height}/{self.round} ({self.block_id}, POL:{self.pol_round})}}"


codec.register("tm/Proposal")(Proposal)
