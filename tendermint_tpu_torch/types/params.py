"""Consensus-critical parameters: the port's copy of
tendermint_tpu/types/params.py.

Reference parity: types/params.go (ConsensusParams/BlockParams/
EvidenceParams/ValidatorParams, defaults, Validate, Hash, Update).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..crypto import tmhash
from ..encoding.proto import field_varint

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB (types/params.go:15)
BLOCK_PART_SIZE_BYTES = 65536  # 64kB (types/params.go:18)
MAX_BLOCK_PARTS_COUNT = MAX_BLOCK_SIZE_BYTES // BLOCK_PART_SIZE_BYTES + 1

ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SR25519 = "sr25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"
ABCI_PUBKEY_TYPE_BLS12381 = "bls12381"
KNOWN_ABCI_PUBKEY_TYPES = (
    ABCI_PUBKEY_TYPE_ED25519,
    ABCI_PUBKEY_TYPE_SR25519,
    ABCI_PUBKEY_TYPE_SECP256K1,
    ABCI_PUBKEY_TYPE_BLS12381,
)


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 22020096  # 21MB default (types/params.go:74)
    max_gas: int = -1
    time_iota_ms: int = 1000


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000


@dataclass(frozen=True)
class ValidatorParams:
    # ed25519 + bls12381 by default so an ABCI-driven ed25519↔BLS set
    # migration needs no genesis param change.  ConsensusParams.hash()
    # covers only block params, so widening the default is hash-safe.
    pub_key_types: tuple = (ABCI_PUBKEY_TYPE_ED25519, ABCI_PUBKEY_TYPE_BLS12381)

    def is_valid_pubkey_type(self, t: str) -> bool:
        return t in self.pub_key_types


@dataclass(frozen=True)
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)

    def validate(self) -> None:
        """Reference types/params.go:104 Validate."""
        b = self.block
        if b.max_bytes <= 0:
            raise ValueError(f"block.max_bytes must be > 0, got {b.max_bytes}")
        if b.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(f"block.max_bytes too big: {b.max_bytes}")
        if b.max_gas < -1:
            raise ValueError(f"block.max_gas must be >= -1, got {b.max_gas}")
        if b.time_iota_ms <= 0:
            raise ValueError("block.time_iota_ms must be > 0")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.max_age_num_blocks must be > 0")
        if self.evidence.max_age_duration_ns <= 0:
            raise ValueError("evidence.max_age_duration_ns must be > 0")
        if not self.validator.pub_key_types:
            raise ValueError("validator.pub_key_types must be non-empty")
        for t in self.validator.pub_key_types:
            if t not in KNOWN_ABCI_PUBKEY_TYPES:
                raise ValueError(f"unknown pubkey type {t!r}")

    def hash(self) -> bytes:
        """Hash of the consensus-critical subset only (max_bytes, max_gas) —
        reference types/params.go:163 HashedParams rationale."""
        bz = field_varint(1, self.block.max_bytes) + field_varint(2, self.block.max_gas)
        return tmhash.sum(bz)

    def update(self, changes: dict | None) -> "ConsensusParams":
        """Apply non-nil sections from an ABCI param update
        (types/params.go:180 Update)."""
        if not changes:
            return self
        res = self
        if "block" in changes and changes["block"] is not None:
            c = changes["block"]
            res = replace(
                res,
                block=replace(
                    res.block,
                    max_bytes=c.get("max_bytes", res.block.max_bytes),
                    max_gas=c.get("max_gas", res.block.max_gas),
                ),
            )
        if "evidence" in changes and changes["evidence"] is not None:
            c = changes["evidence"]
            res = replace(
                res,
                evidence=replace(
                    res.evidence,
                    max_age_num_blocks=c.get(
                        "max_age_num_blocks", res.evidence.max_age_num_blocks
                    ),
                    max_age_duration_ns=c.get(
                        "max_age_duration_ns", res.evidence.max_age_duration_ns
                    ),
                ),
            )
        if "validator" in changes and changes["validator"] is not None:
            c = changes["validator"]
            res = replace(
                res,
                validator=ValidatorParams(tuple(c.get("pub_key_types", ()))),
            )
        return res

    def to_dict(self) -> dict:
        return {
            "block": {
                "max_bytes": self.block.max_bytes,
                "max_gas": self.block.max_gas,
                "time_iota_ms": self.block.time_iota_ms,
            },
            "evidence": {
                "max_age_num_blocks": self.evidence.max_age_num_blocks,
                "max_age_duration_ns": self.evidence.max_age_duration_ns,
            },
            "validator": {"pub_key_types": list(self.validator.pub_key_types)},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ConsensusParams":
        return cls(
            block=BlockParams(
                max_bytes=d["block"]["max_bytes"],
                max_gas=d["block"]["max_gas"],
                time_iota_ms=d["block"].get("time_iota_ms", 1000),
            ),
            evidence=EvidenceParams(
                max_age_num_blocks=d["evidence"]["max_age_num_blocks"],
                max_age_duration_ns=d["evidence"]["max_age_duration_ns"],
            ),
            validator=ValidatorParams(tuple(d["validator"]["pub_key_types"])),
        )


MAX_EVIDENCE_BYTES = 484  # types/evidence.go:21
MAX_VOTE_BYTES = 223  # types/vote.go:15
MAX_HEADER_BYTES = 632  # types/block.go:23
MAX_OVERHEAD_FOR_BLOCK = 11  # types/block.go:34
MAX_CHAIN_ID_LEN = 50  # types/genesis.go:21
MAX_SIGNATURE_SIZE = 96  # fits ed25519(64) and future aggregated sigs
MAX_VOTES_COUNT = 10000  # types/vote_set.go:18


def max_evidence_per_block(block_max_bytes: int) -> tuple[int, int]:
    """(max count, max total bytes) — evidence capped at 1/10 of block size
    (types/evidence.go:92 MaxEvidencePerBlock)."""
    max_bytes = block_max_bytes // 10
    max_num = max_bytes // MAX_EVIDENCE_BYTES
    return max_num, max_bytes
