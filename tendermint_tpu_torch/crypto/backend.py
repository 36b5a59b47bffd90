"""Host-crypto backend: the port's copy of `active_tier`, of the secret
connection's primitives and of the pure-Python secp256k1 ECDSA from
tendermint_tpu/crypto/backend.py.

The JAX package picks among three tiers for serial host work:
`cryptography` (OpenSSL), the project's C library, pure Python.  The port
has no `cryptography` tier (the card's machine lacks the package), so
tier 1 never reports here.  ChaCha20-Poly1305 runs on the C library
(csrc/sha512_batch.c through crypto/hostprep.py) where it builds, else on
the pure tier; X25519 (once per connection) and HKDF-SHA256 are pure, as
the JAX package's tiers 2 and 3 have them.  secp256k1 is the JAX
package's tier-3 branch (RFC 6979 nonces, so its signatures equal that
branch's byte for byte).  Every function's bytes equal the JAX package's
on every tier.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac as _hmac
import os
import struct
from typing import Optional, Tuple


def active_tier() -> int:
    """Best available host-crypto tier for serial ed25519 work: 2 = the
    project C library (csrc/sha512_batch.c), 3 = pure python.  Exported as
    the `tendermint_verify_backend_tier` gauge."""
    from . import hostprep

    return 2 if hostprep._load_lib() is not None else 3


def _clib():
    from . import hostprep

    return hostprep._load_lib()


# --------------------------------------------------------------------------
# ChaCha20-Poly1305 (IETF, 12-byte nonce; RFC 8439)
# --------------------------------------------------------------------------

_CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    def rotl(v, n):
        return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF

    st = (
        list(_CHACHA_CONSTANTS)
        + list(struct.unpack("<8L", key))
        + [counter & 0xFFFFFFFF]
        + list(struct.unpack("<3L", nonce))
    )
    w = st[:]

    def qr(a, b, c, d):
        w[a] = (w[a] + w[b]) & 0xFFFFFFFF
        w[d] = rotl(w[d] ^ w[a], 16)
        w[c] = (w[c] + w[d]) & 0xFFFFFFFF
        w[b] = rotl(w[b] ^ w[c], 12)
        w[a] = (w[a] + w[b]) & 0xFFFFFFFF
        w[d] = rotl(w[d] ^ w[a], 8)
        w[c] = (w[c] + w[d]) & 0xFFFFFFFF
        w[b] = rotl(w[b] ^ w[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack("<16L", *((w[i] + st[i]) & 0xFFFFFFFF for i in range(16)))


def _chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        block = _chacha20_block(key, counter + i // 64, nonce)
        chunk = data[i : i + 64]
        out[i : i + len(chunk)] = bytes(a ^ b for a, b in zip(chunk, block))
    return bytes(out)


def _poly1305(key: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block + b"\x01", "little")
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


def _aead_tag(key: bytes, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
    poly_key = _chacha20_block(key, 0, nonce)[:32]
    mac_data = aad + _pad16(aad) + ct + _pad16(ct) + struct.pack("<QQ", len(aad), len(ct))
    return _poly1305(poly_key, mac_data)


class AEADError(Exception):
    pass


def _seal_pure(key: bytes, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
    ct = _chacha20_xor(key, 1, nonce, data)
    return ct + _aead_tag(key, nonce, aad, ct)


def _open_pure(key: bytes, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    if len(sealed) < 16:
        raise AEADError("sealed frame too short")
    ct, tag = sealed[:-16], sealed[-16:]
    if not _hmac.compare_digest(_aead_tag(key, nonce, aad, ct), tag):
        raise AEADError("invalid tag")
    return _chacha20_xor(key, 1, nonce, ct)


def chacha20poly1305_seal(key: bytes, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
    """ciphertext || 16-byte tag (RFC 8439)."""
    lib = _clib()
    if lib is None:
        return _seal_pure(key, nonce, data, aad)
    out = ctypes.create_string_buffer(len(data) + 16)
    lib.chacha20poly1305_seal(key, nonce, aad, len(aad), data, len(data), out)
    return out.raw


def chacha20poly1305_open(key: bytes, nonce: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    """Decrypt or raise AEADError (constant-time tag compare)."""
    if len(sealed) < 16:
        raise AEADError("sealed frame too short")
    lib = _clib()
    if lib is None:
        return _open_pure(key, nonce, sealed, aad)
    out = ctypes.create_string_buffer(max(len(sealed) - 16, 1))
    if not lib.chacha20poly1305_open(key, nonce, aad, len(aad), sealed, len(sealed), out):
        raise AEADError("invalid tag")
    return out.raw[: len(sealed) - 16]


# --------------------------------------------------------------------------
# X25519 (handshake only: once per connection, pure Python; RFC 7748)
# --------------------------------------------------------------------------

_X25519_P = 2**255 - 19
_X25519_A24 = 121665


def _x25519_scalarmult(k_bytes: bytes, u_bytes: bytes) -> bytes:
    k = int.from_bytes(k_bytes, "little")
    k &= ~7
    k &= (1 << 254) - 1
    k |= 1 << 254
    u = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
    p = _X25519_P
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in reversed(range(255)):
        bit = (k >> t) & 1
        swap ^= bit
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = bit
        A = (x2 + z2) % p
        AA = A * A % p
        B = (x2 - z2) % p
        BB = B * B % p
        E = (AA - BB) % p
        C = (x3 + z3) % p
        D = (x3 - z3) % p
        DA = D * A % p
        CB = C * B % p
        x3 = (DA + CB) % p
        x3 = x3 * x3 % p
        z3 = (DA - CB) % p
        z3 = z3 * z3 % p * x1 % p
        x2 = AA * BB % p
        z2 = E * (AA + _X25519_A24 * E) % p
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, p - 2, p) % p).to_bytes(32, "little")


_X25519_BASE = (9).to_bytes(32, "little")


def x25519_generate() -> Tuple[bytes, bytes]:
    """(private scalar bytes, public u-coordinate bytes)."""
    sk = os.urandom(32)
    return sk, _x25519_scalarmult(sk, _X25519_BASE)


def x25519_shared(priv: bytes, peer_pub: bytes) -> bytes:
    return _x25519_scalarmult(priv, peer_pub)


# --------------------------------------------------------------------------
# HKDF-SHA256 (RFC 5869)
# --------------------------------------------------------------------------


def hkdf_sha256(ikm: bytes, length: int, info: bytes, salt: bytes = b"") -> bytes:
    prk = _hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


# --------------------------------------------------------------------------
# secp256k1 ECDSA (pure Python; the JAX package's tier-3 branch)
# --------------------------------------------------------------------------

SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_SECP_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_SECP_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_SECP_P, _SECP_N = SECP_P, SECP_N


def _secp_add(pt1, pt2):
    if pt1 is None:
        return pt2
    if pt2 is None:
        return pt1
    x1, y1 = pt1
    x2, y2 = pt2
    if x1 == x2 and (y1 + y2) % _SECP_P == 0:
        return None
    if pt1 == pt2:
        lam = (3 * x1 * x1) * pow(2 * y1, _SECP_P - 2, _SECP_P) % _SECP_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, _SECP_P - 2, _SECP_P) % _SECP_P
    x3 = (lam * lam - x1 - x2) % _SECP_P
    return (x3, (lam * (x1 - x3) - y1) % _SECP_P)


def _secp_mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _secp_add(acc, pt)
        pt = _secp_add(pt, pt)
        k >>= 1
    return acc


def _secp_decompress(data: bytes) -> Optional[Tuple[int, int]]:
    if len(data) != 33 or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= _SECP_P:
        return None
    y2 = (x * x * x + 7) % _SECP_P
    y = pow(y2, (_SECP_P + 1) // 4, _SECP_P)
    if y * y % _SECP_P != y2:
        return None
    if (y & 1) != (data[0] & 1):
        y = _SECP_P - y
    return (x, y)


def ecdsa_compress(x: int, y: int) -> bytes:
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def ecdsa_pub_from_priv(priv: bytes) -> bytes:
    """33-byte compressed pubkey."""
    d = int.from_bytes(priv, "big")
    pt = _secp_mul(d, (_SECP_GX, _SECP_GY))
    return ecdsa_compress(*pt)


def ecdsa_generate() -> bytes:
    while True:
        d = int.from_bytes(os.urandom(32), "big")
        if 0 < d < _SECP_N:
            return d.to_bytes(32, "big")


def _rfc6979_k(priv: bytes, digest: bytes) -> int:
    """Deterministic nonce (RFC 6979, SHA-256)."""
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = _hmac.new(k, v + b"\x00" + priv + digest, hashlib.sha256).digest()
    v = _hmac.new(k, v, hashlib.sha256).digest()
    k = _hmac.new(k, v + b"\x01" + priv + digest, hashlib.sha256).digest()
    v = _hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = _hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 0 < cand < _SECP_N:
            return cand
        k = _hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = _hmac.new(k, v, hashlib.sha256).digest()


def ecdsa_sign(priv: bytes, msg: bytes) -> Tuple[int, int]:
    """SHA-256 ECDSA, low-S normalized; returns (r, s)."""
    digest = hashlib.sha256(msg).digest()
    z = int.from_bytes(digest, "big")
    d = int.from_bytes(priv, "big")
    while True:
        k = _rfc6979_k(priv, digest)
        pt = _secp_mul(k, (_SECP_GX, _SECP_GY))
        r = pt[0] % _SECP_N
        if r == 0:
            continue
        s = pow(k, _SECP_N - 2, _SECP_N) * (z + r * d) % _SECP_N
        if s == 0:
            continue
        if s > _SECP_N // 2:
            s = _SECP_N - s
        return r, s


def ecdsa_verify(pub33: bytes, msg: bytes, r: int, s: int) -> bool:
    if not (0 < r < _SECP_N and 0 < s < _SECP_N):
        return False
    pt = _secp_decompress(pub33)
    if pt is None:
        return False
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, _SECP_N - 2, _SECP_N)
    u1 = z * w % _SECP_N
    u2 = r * w % _SECP_N
    res = _secp_add(_secp_mul(u1, (_SECP_GX, _SECP_GY)), _secp_mul(u2, pt))
    if res is None:
        return False
    return res[0] % _SECP_N == r
