"""XChaCha20-Poly1305 AEAD (24-byte nonces); the port's copy of
tendermint_tpu/crypto/xchacha20poly1305.py.

Reference parity: crypto/xchacha20poly1305/xchachapoly.go — the extended-
nonce AEAD the reference keeps for symmetric encryption needs.  Built as
the standard construction: HChaCha20(key, nonce[:16]) derives a subkey,
then IETF ChaCha20-Poly1305 runs with nonce 0x00000000 ‖ nonce[16:24].
HChaCha20 is implemented from the ChaCha20 quarter-round directly
(draft-irtf-cfrg-xchacha-03); the inner AEAD comes from `crypto.backend`
(the project C library where it builds, else pure Python).
"""

from __future__ import annotations

import struct

from . import backend

KEY_SIZE = 32
NONCE_SIZE = 24

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF


def _quarter_round(st, a, b, c, d) -> None:
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] = _rotl32(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] = _rotl32(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] = _rotl32(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] = _rotl32(st[b] ^ st[c], 7)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """draft-irtf-cfrg-xchacha-03 §2.2."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("hchacha20 wants a 32-byte key and 16-byte nonce")
    st = list(_CONSTANTS) + list(struct.unpack("<8L", key)) + list(struct.unpack("<4L", nonce16))
    for _ in range(10):
        _quarter_round(st, 0, 4, 8, 12)
        _quarter_round(st, 1, 5, 9, 13)
        _quarter_round(st, 2, 6, 10, 14)
        _quarter_round(st, 3, 7, 11, 15)
        _quarter_round(st, 0, 5, 10, 15)
        _quarter_round(st, 1, 6, 11, 12)
        _quarter_round(st, 2, 7, 8, 13)
        _quarter_round(st, 3, 4, 9, 14)
    return struct.pack("<4L", *st[0:4]) + struct.pack("<4L", *st[12:16])


class XChaCha20Poly1305:
    """Same interface shape as the library AEADs: seal/open."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise ValueError(f"xchacha20poly1305 key must be {KEY_SIZE} bytes")
        self._key = bytes(key)

    def _inner(self, nonce: bytes) -> tuple:
        if len(nonce) != NONCE_SIZE:
            raise ValueError(f"nonce must be {NONCE_SIZE} bytes")
        subkey = hchacha20(self._key, nonce[:16])
        return subkey, b"\x00" * 4 + nonce[16:]

    def seal(self, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
        subkey, n12 = self._inner(nonce)
        return backend.chacha20poly1305_seal(subkey, n12, plaintext, aad)

    def open(self, nonce: bytes, ciphertext: bytes, aad: bytes = b"") -> bytes:
        subkey, n12 = self._inner(nonce)
        return backend.chacha20poly1305_open(subkey, n12, ciphertext, aad)
