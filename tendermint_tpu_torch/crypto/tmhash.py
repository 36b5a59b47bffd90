"""tmhash: SHA256 and the 20-byte truncated variant used for addresses.

Reference parity: crypto/tmhash/hash.go; AddressSize=20 (crypto/crypto.go:10).
"""

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum_sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


sum = sum_sha256  # reference name: tmhash.Sum


def sum_truncated(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
