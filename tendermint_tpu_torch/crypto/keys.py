"""ed25519 keys: the consensus key type.

Reference parity: crypto/ed25519/ed25519.go (address = SHA256(pubkey)[:20],
ed25519.go:138; GenPrivKeyFromSecret, ed25519.go:106).  Signing, public-key
derivation and single verification go through the package's C library
(csrc/sha512_batch.c, loaded by hostprep), with the pure-Python
ed25519_math path only where that library cannot be built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

from ..encoding.codec import register
from . import ed25519_math as em
from . import hostprep
from .tmhash import sum_truncated

ADDRESS_SIZE = 20


def _expand_seed(seed: bytes):
    """RFC 8032 §5.1.5: (clamped scalar LE32, prefix32)."""
    h = hashlib.sha512(seed).digest()
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 63
    a[31] |= 64
    return bytes(a), h[32:]


@register("pk/ed25519")
class Ed25519PubKey:
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

    def __repr__(self) -> str:
        return f"Ed25519PubKey({self._data.hex()[:16]}…)"


class Ed25519PrivKey:
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


def pubkey_from_dict(d: dict) -> Ed25519PubKey:
    """Route a {"type", "value"} dict to its key; this slice carries
    ed25519 keys only, and any other type raises as an unknown one."""
    t = d.get("type")
    if t == Ed25519PubKey.TYPE:
        return Ed25519PubKey(d["value"])
    raise ValueError(f"unknown pubkey type {t!r}")


# the JAX package's other key types, each waiting for its slice
_LATER_PRIV_TYPES = {
    "tendermint/PrivKeySr25519": "1.8 (sr25519)",
    "tendermint/PrivKeySecp256k1": "1.8 (secp256k1)",
    "tendermint/PrivKeyBLS12381": "1.9 (bls12381)",
}
_LATER_KEY_TYPES = {"sr25519": "1.8", "secp256k1": "1.8", "bls12381": "1.9"}

# key-type names the JAX package accepts (`testnet --key-type`,
# FilePV.generate)
KEY_TYPES = ("ed25519", "sr25519", "bls12381", "secp256k1")


def privkey_from_dict(d: dict) -> Ed25519PrivKey:
    """Route a {"type", "value"} dict to its key — the privval key-file
    loader's dispatch.  This slice carries ed25519 keys only; the JAX
    package's other types raise TypeError naming the ROADMAP item that
    ports them."""
    t = d.get("type")
    if t == Ed25519PrivKey.TYPE:
        return Ed25519PrivKey(d["value"])
    if t in _LATER_PRIV_TYPES:
        raise TypeError(f"{t} keys are not ported yet (ROADMAP {_LATER_PRIV_TYPES[t]})")
    raise ValueError(f"unknown privkey type {t!r}")


def generate_priv_key(key_type: str = "ed25519") -> Ed25519PrivKey:
    if key_type == "ed25519":
        return Ed25519PrivKey.generate()
    if key_type in _LATER_KEY_TYPES:
        raise TypeError(
            f"{key_type} keys are not ported yet (ROADMAP {_LATER_KEY_TYPES[key_type]})"
        )
    raise ValueError(f"unknown key type {key_type!r} (want one of {KEY_TYPES})")
