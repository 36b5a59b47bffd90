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

`resolve_mesh` and `Mesh` are the verify engine's device mesh, JAX's
`resolve_mesh` on torch devices.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import hmac as _hmac
import os
import struct
import threading
from typing import Optional, Sequence, Tuple


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
# device mesh probe (the batch engine's scale axis)
# --------------------------------------------------------------------------


class Mesh:
    """The verify engine's mesh: an ordered list of torch devices along one
    axis, the batch axis (a one-axis `jax.sharding.Mesh` named "batch").  A
    batch of b rows, b a multiple of `size`, gives shard k its k-th
    contiguous slice of b / size rows: the slice `NamedSharding(mesh,
    P("batch"))` gives device k.  Shards run in this process, each on a
    CUDA stream of its own (`on_shard`), so no collective and no process
    group is needed.

    A device may be listed more than once (virtual shards over one card or
    over the CPU); `resolve_mesh` itself never lists a card twice."""

    AXIS = "batch"

    def __init__(self, devices: Sequence):
        import torch

        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one kind, got {devs}")
        self.devices = tuple(devs)
        self.size = len(devs)
        self.shape = {self.AXIS: self.size}
        self._streams = None
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def lead(self, device=None):
        """The mesh's first device, where its unsharded work runs.  A caller
        that names a device must name this one (a card without an index
        stands for any card); anything else raises rather than move the
        caller's work onto other devices."""
        import torch

        first = self.devices[0]
        if device is not None:
            d = torch.device(device)
            if d != first and not (d.type == first.type == "cuda" and d.index is None):
                raise ValueError(f"device {d} is not the mesh's first device: {self}")
        return first

    def distinct(self) -> list:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def streams(self) -> tuple:
        """One CUDA stream per shard, made at first use; None for a shard
        on the CPU."""
        with self._lock:
            if self._streams is None:
                import torch

                self._streams = tuple(
                    torch.cuda.Stream(device=d) if d.type == "cuda" else None
                    for d in self.devices
                )
            return self._streams

    @contextlib.contextmanager
    def on_shard(self, k: int):
        """Run the block's device work on shard k: its device current and
        its own stream current, after the work already queued on that
        device's current stream (the caller's uploads).  Yields the stream
        (None on the CPU, where the block just runs)."""
        stream = self.streams()[k]
        if stream is None:
            yield None
            return
        import torch

        dev = self.devices[k]
        with torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                yield stream


def resolve_mesh(
    mode: str = "auto", max_devices: int = 0, device=None, cpu_shards: int = 1
) -> Tuple[Optional[Mesh], int, str]:
    """Probe the visible devices and decide the verify engine's mesh: the
    JAX package's (mesh_or_None, shard_count, reason) triple, which the node
    logs at start and exports as `tendermint_verify_shards`.

    `device` None or "cuda" probes the cards: the visible devices are the
    `torch.cuda.device_count()` distinct cards, and the mesh lists each
    once.  A card named with its index ("cuda:2") pins the engine to it:
    "auto" keeps to that card, and "on" shards over the cards from it on,
    so that nodes given different cards do not share them.  `device="cpu"`
    makes `cpu_shards` virtual CPU shards visible instead (the counterpart
    of JAX's xla_force_host_platform_device_count).

    Modes ([tpu] mesh), with JAX's rules:
      "auto" — shard over every visible device when there is more than
               one, except virtual CPU shards, unless mesh_devices > 1;
      "on"   — shard whenever more than one device is visible;
      "off"  — never shard.
    `max_devices` ([tpu] mesh_devices) caps the shard count; 0 = all.

    Unlike JAX, which degrades a failed probe to one device with the
    failure in the reason, a failed probe raises: the engine must not hide
    a broken device plane behind fewer shards."""
    if mode == "off":
        return None, 1, "mesh off (config)"
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available")
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.index is not None and dev not in devs:
                raise RuntimeError(f"{dev} is not one of the {len(devs)} visible cards")
            backend = "cuda"
        else:
            devs = [dev] * cpu_shards
            backend = dev.type
    except Exception as e:
        raise RuntimeError(f"mesh probe failed: {e!r}") from e
    named = ""
    if dev.type == "cuda" and dev.index is not None:
        if mode != "on":
            return None, 1, f"single device ({dev} named, {len(devs)} visible, {backend})"
        named = f" from {dev}"
        devs = devs[dev.index:]
    cap = max_devices if max_devices > 0 else len(devs)
    cap = min(cap, len(devs))
    if cap <= 1:
        return None, 1, f"single device ({len(devs)} visible{named}, {backend})"
    if mode == "auto" and backend == "cpu" and max_devices <= 1:
        return None, 1, (
            f"{len(devs)} virtual cpu devices ignored by mesh=auto "
            "(set mesh=on or mesh_devices to shard)"
        )
    return Mesh(devs[:cap]), cap, f"sharded over {cap}/{len(devs)} {backend} devices{named}"


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
