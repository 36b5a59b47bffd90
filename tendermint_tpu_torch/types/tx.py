"""Transactions, merkle proofs over them, and ABCI result hashing: the
port's copy of tendermint_tpu/types/tx.py.

Reference parity: types/tx.go (Tx.Hash:22, Txs.Hash:36, TxProof:87),
types/results.go (ABCIResult:14, ABCIResults.Hash:60).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..crypto import merkle, tmhash
from ..encoding.proto import field_bytes, field_varint


def tx_hash(tx: bytes) -> bytes:
    return tmhash.sum(tx)


def txs_hash(txs: Sequence[bytes]) -> bytes:
    """Merkle root over tx hashes (leaves are TxIDs, types/tx.go:36)."""
    return merkle.hash_from_byte_slices([tx_hash(t) for t in txs])


def tx_index(txs: Sequence[bytes], tx: bytes) -> int:
    for i, t in enumerate(txs):
        if t == tx:
            return i
    return -1


def tx_index_by_hash(txs: Sequence[bytes], h: bytes) -> int:
    for i, t in enumerate(txs):
        if tx_hash(t) == h:
            return i
    return -1


@dataclass(frozen=True)
class TxProof:
    """Merkle inclusion proof for one tx (types/tx.go:87)."""

    root_hash: bytes
    data: bytes
    proof: merkle.SimpleProof

    def leaf(self) -> bytes:
        return tx_hash(self.data)

    def validate(self, data_hash: bytes) -> None:
        if data_hash != self.root_hash:
            raise ValueError("proof matches different data hash")
        if self.proof.index < 0:
            raise ValueError("proof index cannot be negative")
        if self.proof.total <= 0:
            raise ValueError("proof total must be positive")
        if not self.proof.verify(self.root_hash, self.leaf()):
            raise ValueError("proof is not internally consistent")

    def to_dict(self) -> dict:
        return {"root_hash": self.root_hash, "data": self.data, "proof": self.proof.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "TxProof":
        return cls(d["root_hash"], d["data"], merkle.SimpleProof.from_dict(d["proof"]))


def tx_proof(txs: Sequence[bytes], i: int) -> TxProof:
    """types/tx.go:69."""
    root, proofs = merkle.proofs_from_byte_slices([tx_hash(t) for t in txs])
    return TxProof(root_hash=root, data=bytes(txs[i]), proof=proofs[i])


@dataclass(frozen=True)
class ABCIResult:
    """Deterministic component of a DeliverTx response (types/results.go:14)."""

    code: int
    data: bytes

    def bytes(self) -> bytes:
        return field_varint(1, self.code) + field_bytes(2, self.data)


def results_hash(results: List[ABCIResult]) -> bytes:
    """types/results.go:60."""
    return merkle.hash_from_byte_slices([r.bytes() for r in results])


def results_from_responses(responses: List) -> List[ABCIResult]:
    """From abci DeliverTx responses (types/results.go:28)."""
    return [ABCIResult(code=r.code, data=r.data) for r in responses]
