"""Key types: ed25519 (consensus default), secp256k1, and the dispatch that
also routes sr25519 (crypto/sr25519.py) and threshold multisig
(crypto/multisig.py).

Reference parity: `crypto.PubKey`/`PrivKey` interfaces (crypto/crypto.go:22,29),
ed25519 keys (crypto/ed25519/ed25519.go; address = SHA256(pubkey)[:20],
ed25519.go:138; GenPrivKeyFromSecret, ed25519.go:106), secp256k1 keys
(crypto/secp256k1/; 33-byte compressed keys, address =
RIPEMD160(SHA256(pubkey)), lower-S signatures).

ed25519 signing, public-key derivation and single verification go through
the package's C library (csrc/sha512_batch.c, loaded by hostprep), with the
pure-Python ed25519_math path only where that library cannot be built.
secp256k1 runs on crypto/backend.py's pure-Python ECDSA (RFC 6979 nonces).
bls12381 keys live in crypto/bls/ (a C pairing tier on the host, with the
pure-Python tower as its reference).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from abc import ABC, abstractmethod

from ..encoding.codec import register
from . import backend
from . import ed25519_math as em
from . import hostprep
from .tmhash import sum_truncated

ADDRESS_SIZE = 20


class PubKey(ABC):
    TYPE: str = ""

    @abstractmethod
    def address(self) -> bytes: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def verify(self, msg: bytes, sig: bytes) -> bool: ...

    def equals(self, other: "PubKey") -> bool:
        return type(self) is type(other) and self.bytes() == other.bytes()

    def __eq__(self, other) -> bool:
        return isinstance(other, PubKey) and self.equals(other)

    def __hash__(self) -> int:
        return hash((self.TYPE, self.bytes()))

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "value": self.bytes()}

    @classmethod
    def from_dict(cls, d: dict) -> "PubKey":
        return pubkey_from_dict(d)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.bytes().hex()[:16]}…)"


class PrivKey(ABC):
    TYPE: str = ""

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abstractmethod
    def pub_key(self) -> PubKey: ...


# ---------------------------------------------------------------------------
# ed25519
# ---------------------------------------------------------------------------


def _expand_seed(seed: bytes):
    """RFC 8032 §5.1.5: (clamped scalar LE32, prefix32)."""
    h = hashlib.sha512(seed).digest()
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 63
    a[31] |= 64
    return bytes(a), h[32:]


@register("pk/ed25519")
class Ed25519PubKey(PubKey):
    TYPE = "tendermint/PubKeyEd25519"
    SIZE = 32
    SIG_SIZE = 64

    def __init__(self, data: bytes):
        if len(data) != self.SIZE:
            raise ValueError(f"ed25519 pubkey must be {self.SIZE} bytes")
        self._data = bytes(data)

    def address(self) -> bytes:
        return sum_truncated(self._data)

    def bytes(self) -> bytes:
        return self._data

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "value": self._data}

    @classmethod
    def from_dict(cls, d: dict) -> "Ed25519PubKey":
        return cls(d["value"])

    def verify(self, msg: bytes, sig: bytes) -> bool:
        """Single host verify, cofactorless, non-canonical S rejected."""
        if len(sig) != self.SIG_SIZE or not em.sc_minimal(sig[32:]):
            return False
        lib = hostprep._load_lib()
        if lib is not None:
            return bool(lib.ed25519_verify(self._data, msg, len(msg), sig))
        return em.verify(self._data, msg, sig)

    def __eq__(self, other) -> bool:
        return isinstance(other, Ed25519PubKey) and self._data == other._data

    def __hash__(self) -> int:
        return hash((self.TYPE, self._data))


class Ed25519PrivKey(PrivKey):
    TYPE = "tendermint/PrivKeyEd25519"
    SIZE = 32  # seed

    def __init__(self, seed: bytes):
        if len(seed) == 64:  # tolerate golang-style seed||pub concatenation
            seed = seed[:32]
        if len(seed) != self.SIZE:
            raise ValueError("ed25519 privkey must be a 32-byte seed")
        self._seed = bytes(seed)
        lib = hostprep._load_lib()
        if lib is not None:
            out = ctypes.create_string_buffer(32)
            lib.ed25519_pubkey(self._seed, out)
            pub = out.raw
        else:
            scalar, _ = _expand_seed(self._seed)
            pub = em.compress(*em.to_affine(em.scalar_mult(int.from_bytes(scalar, "little"), em.BASE)))
        self._pub = Ed25519PubKey(pub)

    @classmethod
    def generate(cls) -> "Ed25519PrivKey":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_secret(cls, secret: bytes) -> "Ed25519PrivKey":
        """Deterministic key from a secret: SHA256 of the secret as seed."""
        return cls(hashlib.sha256(secret).digest())

    def bytes(self) -> bytes:
        return self._seed

    def sign(self, msg: bytes) -> bytes:
        lib = hostprep._load_lib()
        if lib is not None:
            out = ctypes.create_string_buffer(64)
            lib.ed25519_sign(self._seed, self._pub.bytes(), msg, len(msg), out)
            return out.raw
        scalar, prefix = _expand_seed(self._seed)
        return em.sign(scalar, prefix, self._pub.bytes(), msg)

    def pub_key(self) -> Ed25519PubKey:
        return self._pub

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "value": self._seed}

    @classmethod
    def from_dict(cls, d: dict) -> "Ed25519PrivKey":
        return cls(d["value"])


# ---------------------------------------------------------------------------
# secp256k1 (ECDSA).  Reference: crypto/secp256k1/secp256k1.go — 33-byte
# compressed pubkeys, address = RIPEMD160(SHA256(pub)), lower-S signatures
# (secp256k1_nocgo.go:34 malleability check), 64-byte r||s encoding.
# ---------------------------------------------------------------------------

_SECP_N = backend.SECP_N


@register("pk/secp256k1")
class Secp256k1PubKey(PubKey):
    TYPE = "tendermint/PubKeySecp256k1"
    SIZE = 33

    def __init__(self, data: bytes):
        if len(data) != self.SIZE:
            raise ValueError(f"secp256k1 pubkey must be {self.SIZE} bytes")
        self._data = bytes(data)

    def address(self) -> bytes:
        sha = hashlib.sha256(self._data).digest()
        return hashlib.new("ripemd160", sha).digest()

    def bytes(self) -> bytes:
        return self._data

    def verify(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != 64:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if s > _SECP_N // 2:  # reject malleable high-S, parity with reference
            return False
        return backend.ecdsa_verify(self._data, msg, r, s)

    @classmethod
    def from_dict(cls, d: dict) -> "Secp256k1PubKey":
        return cls(d["value"])


@register("sk/secp256k1")
class Secp256k1PrivKey(PrivKey):
    TYPE = "tendermint/PrivKeySecp256k1"
    SIZE = 32

    def __init__(self, data: bytes):
        if len(data) != self.SIZE:
            raise ValueError("secp256k1 privkey must be 32 bytes")
        self._data = bytes(data)
        self._pub = Secp256k1PubKey(backend.ecdsa_pub_from_priv(self._data))

    @classmethod
    def generate(cls) -> "Secp256k1PrivKey":
        return cls(backend.ecdsa_generate())

    def bytes(self) -> bytes:
        return self._data

    def sign(self, msg: bytes) -> bytes:
        r, s = backend.ecdsa_sign(self._data, msg)  # low-S normalized
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> Secp256k1PubKey:
        return self._pub

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "value": self._data}

    @classmethod
    def from_dict(cls, d: dict) -> "Secp256k1PrivKey":
        return cls(d["value"])


# ---------------------------------------------------------------------------

def pubkey_from_dict(d: dict) -> PubKey:
    t = d.get("type")
    for cls in (Ed25519PubKey, Secp256k1PubKey):
        if t == cls.TYPE:
            return cls(d["value"])
    from .sr25519 import Sr25519PubKey  # cyclic at import time

    if t == Sr25519PubKey.TYPE:
        return Sr25519PubKey(d["value"])
    if t == "tendermint/PubKeyBLS12381":
        from .bls import BlsPubKey  # lazy: the field tower is import-heavy

        return BlsPubKey(d["value"])
    from .multisig import MultisigThresholdPubKey  # cyclic at import time

    if t == MultisigThresholdPubKey.TYPE:
        return MultisigThresholdPubKey.from_dict(d)
    raise ValueError(f"unknown pubkey type {t!r}")


def privkey_from_dict(d: dict) -> PrivKey:
    """Route a {"type", "value"} dict to the concrete PrivKey — the
    privval key-file loader's dispatch (mirrors pubkey_from_dict)."""
    t = d.get("type")
    if t == Ed25519PrivKey.TYPE:
        return Ed25519PrivKey(d["value"])
    if t == Secp256k1PrivKey.TYPE:
        return Secp256k1PrivKey(d["value"])
    from .sr25519 import Sr25519PrivKey

    if t == Sr25519PrivKey.TYPE:
        return Sr25519PrivKey(d["value"])
    if t == "tendermint/PrivKeyBLS12381":
        from .bls import BlsPrivKey

        return BlsPrivKey(d["value"])
    raise ValueError(f"unknown privkey type {t!r}")


# key-type names accepted by `testnet --key-type` / FilePV.generate —
# mirrors the reference's key-type plumbing (sr25519 rode the same path)
KEY_TYPES = ("ed25519", "sr25519", "bls12381", "secp256k1")


def generate_priv_key(key_type: str = "ed25519") -> PrivKey:
    if key_type == "ed25519":
        return Ed25519PrivKey.generate()
    if key_type == "secp256k1":
        return Secp256k1PrivKey.generate()
    if key_type == "sr25519":
        from .sr25519 import Sr25519PrivKey

        return Sr25519PrivKey.generate()
    if key_type == "bls12381":
        from .bls import BlsPrivKey

        return BlsPrivKey.generate()
    raise ValueError(f"unknown key type {key_type!r} (want one of {KEY_TYPES})")
