"""BLS12-381 key types behind the polymorphic `crypto.PubKey`/`PrivKey`.

Address derivation matches the framework's other key types
(sha256-truncated-20 over the 48-byte compressed pubkey).  Vote signing
uses TIMESTAMP-FREE canonical sign-bytes (types/vote.py bls_sign_bytes):
every +2/3 precommit for a block then signs the identical message, which
is what lets commit assembly fold them into one aggregate signature
checked by a single pairing (fast_aggregate_verify).  Proposals keep the
standard sign-bytes — they are never aggregated.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from ...encoding.codec import register
from ..tmhash import sum_truncated
from . import curve, scheme
from ..keys import PrivKey, PubKey

PUBKEY_SIZE = scheme.PUBKEY_SIZE
SIGNATURE_SIZE = scheme.SIGNATURE_SIZE


@register("pk/bls12381")
class BlsPubKey(PubKey):
    TYPE = "tendermint/PubKeyBLS12381"
    SIZE = PUBKEY_SIZE
    SIG_SIZE = SIGNATURE_SIZE

    def __init__(self, data: bytes):
        if len(data) != self.SIZE:
            raise ValueError(f"bls12381 pubkey must be {self.SIZE} bytes")
        self._data = bytes(data)
        self._point = None  # decompressed lazily, cached (subgroup-checked)

    def address(self) -> bytes:
        return sum_truncated(self._data)

    def bytes(self) -> bytes:
        return self._data

    def point(self):
        """Decompressed G1 point, or None for an invalid encoding."""
        if self._point is None:
            self._point = curve.g1_decompress(self._data)
        return self._point

    def verify(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != self.SIG_SIZE:
            return False
        if scheme.active_tier() == "c":
            # the C tier keeps its own bounded decompress memo — forcing
            # the pure-Python decompress here would cost more than the
            # whole C pairing
            return scheme.verify(self._data, msg, sig)
        pt = self.point()
        if pt is None:
            return False
        return scheme.verify(self._data, msg, sig, pk_point=pt)

    def verify_pop(self, proof: bytes) -> bool:
        return scheme.pop_verify(self._data, proof)

    @classmethod
    def from_dict(cls, d: dict) -> "BlsPubKey":
        return cls(d["value"])


@register("sk/bls12381")
class BlsPrivKey(PrivKey):
    TYPE = "tendermint/PrivKeyBLS12381"
    SIZE = 32  # ikm/seed; the scalar is derived via the HKDF keygen

    def __init__(self, seed: bytes):
        if len(seed) != self.SIZE:
            raise ValueError("bls12381 privkey must be a 32-byte seed")
        self._seed = bytes(seed)
        self._sk = scheme.keygen(self._seed)
        self._pub = BlsPubKey(scheme.sk_to_pk(self._sk))
        self._pop: Optional[bytes] = None

    @classmethod
    def generate(cls) -> "BlsPrivKey":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_secret(cls, secret: bytes) -> "BlsPrivKey":
        return cls(hashlib.sha256(b"bls12381:" + secret).digest())

    def bytes(self) -> bytes:
        return self._seed

    def sign(self, msg: bytes) -> bytes:
        return scheme.sign(self._sk, msg)

    def pub_key(self) -> BlsPubKey:
        return self._pub

    def pop(self) -> bytes:
        """Proof of possession (cached — it's deterministic)."""
        if self._pop is None:
            self._pop = scheme.pop_prove(self._sk)
        return self._pop

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "value": self._seed}

    @classmethod
    def from_dict(cls, d: dict) -> "BlsPrivKey":
        return cls(d["value"])
