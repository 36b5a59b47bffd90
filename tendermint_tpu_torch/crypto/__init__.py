"""Crypto layer of the port: the key types (ed25519, secp256k1, and through
the dispatch sr25519 and threshold multisig), tmhash, the merkle root, the
pure-Python curve oracle, host batch prep (C via ctypes), the batch-verify
hooks and the GPU batch verifier, which verifies ed25519 only."""

from .keys import (
    PubKey,
    PrivKey,
    Ed25519PrivKey,
    Ed25519PubKey,
    Secp256k1PrivKey,
    Secp256k1PubKey,
    pubkey_from_dict,
    ADDRESS_SIZE,
)
from .tmhash import sum_sha256, sum_truncated, TRUNCATED_SIZE

__all__ = [
    "PubKey",
    "PrivKey",
    "Ed25519PrivKey",
    "Ed25519PubKey",
    "Secp256k1PrivKey",
    "Secp256k1PubKey",
    "pubkey_from_dict",
    "ADDRESS_SIZE",
    "sum_sha256",
    "sum_truncated",
    "TRUNCATED_SIZE",
]
