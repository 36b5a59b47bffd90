"""RFC-6962-style simple Merkle tree + proofs: the port's copy of
tendermint_tpu/crypto/merkle.py.

Reference parity: crypto/merkle/simple_tree.go:9 (SimpleHashFromByteSlices),
crypto/merkle/hash.go (leaf/inner domain separation: leaf = SHA256(0x00||v),
inner = SHA256(0x01||l||r)), crypto/merkle/simple_proof.go (SimpleProof).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"


def _leaf_hash(data: bytes) -> bytes:
    return hashlib.sha256(_LEAF_PREFIX + data).digest()


def _inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(_INNER_PREFIX + left + right).digest()


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (simple_tree.go getSplitPoint)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: List[bytes]) -> bytes:
    """Merkle root; empty list hashes to the empty-input SHA256 like the
    reference's emptyHash (crypto/merkle/simple_tree.go:15)."""
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return _leaf_hash(items[0])
    k = _split_point(n)
    return _inner_hash(hash_from_byte_slices(items[:k]), hash_from_byte_slices(items[k:]))


@dataclass
class SimpleProof:
    """Inclusion proof for item `index` of `total` (simple_proof.go:14)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    def compute_root(self) -> Optional[bytes]:
        return _compute_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or not (0 <= self.index < self.total):
            return False
        if _leaf_hash(leaf) != self.leaf_hash:
            return False
        return self.compute_root() == root

    def to_dict(self) -> dict:
        return {
            "total": self.total,
            "index": self.index,
            "leaf_hash": self.leaf_hash,
            "aunts": list(self.aunts),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SimpleProof":
        return cls(d["total"], d["index"], d["leaf_hash"], list(d["aunts"]))


def _compute_from_aunts(index: int, total: int, leaf: bytes, aunts: List[bytes]) -> Optional[bytes]:
    if total == 0 or index >= total:
        return None
    if total == 1:
        return leaf if not aunts else None
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, leaf, aunts[:-1])
        if left is None:
            return None
        return _inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, leaf, aunts[:-1])
    if right is None:
        return None
    return _inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: List[bytes]) -> tuple[bytes, List[SimpleProof]]:
    """Root + per-item proofs (simple_proof.go:32 SimpleProofsFromByteSlices)."""
    trails, root_node = _trails_from_byte_slices(items)
    root = root_node.hash if root_node else hashlib.sha256(b"").digest()
    proofs = []
    for i, trail in enumerate(trails):
        proofs.append(
            SimpleProof(
                total=len(items), index=i, leaf_hash=trail.hash, aunts=trail.flatten_aunts()
            )
        )
    return root, proofs


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent: Optional[_Node] = None
        self.left: Optional[_Node] = None  # sibling trail links
        self.right: Optional[_Node] = None

    def flatten_aunts(self) -> List[bytes]:
        out = []
        node: Optional[_Node] = self
        while node is not None:
            if node.left is not None:
                out.append(node.left.hash)
            elif node.right is not None:
                out.append(node.right.hash)
            node = node.parent
        return out


def _trails_from_byte_slices(items: List[bytes]):
    n = len(items)
    if n == 0:
        return [], None
    if n == 1:
        node = _Node(_leaf_hash(items[0]))
        return [node], node
    k = _split_point(n)
    lefts, left_root = _trails_from_byte_slices(items[:k])
    rights, right_root = _trails_from_byte_slices(items[k:])
    root = _Node(_inner_hash(left_root.hash, right_root.hash))
    for t in lefts:
        top = t
        while top.parent is not None:
            top = top.parent
        if top is not root:
            top.right = right_root
            top.parent = root
    for t in rights:
        top = t
        while top.parent is not None:
            top = top.parent
        if top is not root:
            top.left = left_root
            top.parent = root
    return lefts + rights, root
