"""RFC-6962-style simple Merkle root: the port's copy of
tendermint_tpu/crypto/merkle.py's tree hash (proofs are not part of this
slice).

Reference parity: crypto/merkle/simple_tree.go:9 (SimpleHashFromByteSlices),
crypto/merkle/hash.go (leaf/inner domain separation: leaf = SHA256(0x00||v),
inner = SHA256(0x01||l||r)).
"""

from __future__ import annotations

import hashlib
from typing import List

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
