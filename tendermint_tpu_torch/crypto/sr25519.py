"""sr25519: Schnorr signatures over ristretto255 with Merlin transcripts
(the port's copy of tendermint_tpu/crypto/sr25519.py; signatures are
deterministic, so both packages sign the same bytes).

Reference parity: crypto/sr25519/ (pubkey.go:35 VerifyBytes,
privkey.go Sign) which wraps ChainSafe/go-schnorrkel.  Protocol shape
follows schnorrkel: a "SigningContext" transcript absorbs the context
label and message, the signing transcript absorbs proto-name/pk/R and
challenges a scalar, the signature is (R_compressed, s) with the
schnorrkel marker bit set on the high byte of s.

Address derivation matches the framework's other key types
(sha256-truncated-20, crypto/tmhash).
"""

from __future__ import annotations

import os
from typing import Optional

from ..encoding.codec import register
from . import ed25519_math as em
from . import ristretto
from .keys import PrivKey, PubKey
from .strobe import Transcript
from .tmhash import sum_truncated

# The reference signs with an EMPTY context: privkey.go:32 / pubkey.go:49
# call schnorrkel.NewSigningContext([]byte{}, msg).
SIGNING_CTX = b""
_MARKER = 0x80  # schnorrkel "signature version" bit on s[31]


def _expand_ed25519(mini_secret: bytes) -> tuple[int, bytes]:
    """schnorrkel MiniSecretKey::expand_ed25519 (the mode the reference's
    go-schnorrkel uses): h = SHA-512(mini); scalar = clamp(h[:32]) / 8
    (ed25519-style clamp, then divide out the cofactor byte-wise); nonce =
    h[32:].  The divided scalar is < 2^252 so it is already canonical."""
    import hashlib

    h = hashlib.sha512(mini_secret).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    # divide_scalar_bytes_by_cofactor: shift the little-endian array right
    # 3 bits, carrying remainders downward from the most significant byte
    low = 0
    for i in range(31, -1, -1):
        r = key[i] & 0b111
        key[i] = (key[i] >> 3) + low
        low = (r << 5) & 0xFF
    return int.from_bytes(bytes(key), "little"), h[32:]


def _signing_transcript(ctx: bytes, msg: bytes) -> Transcript:
    t = Transcript(b"SigningContext")
    t.append_message(b"", ctx)
    t.append_message(b"sign-bytes", msg)
    return t


def _challenge(t: Transcript, pub_bytes: bytes, r_bytes: bytes) -> int:
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pub_bytes)
    t.append_message(b"sign:R", r_bytes)
    return int.from_bytes(t.challenge_bytes(b"sign:c", 64), "little") % em.L


class Sr25519PubKey(PubKey):
    TYPE = "tendermint/PubKeySr25519"
    SIZE = 32

    def __init__(self, data: bytes):
        if len(data) != self.SIZE:
            raise ValueError(f"sr25519 pubkey must be {self.SIZE} bytes")
        self._data = bytes(data)
        self._point: Optional[em.Point] = None  # decoded lazily

    def bytes(self) -> bytes:
        return self._data

    def address(self) -> bytes:
        return sum_truncated(self._data)

    def _decoded(self) -> Optional[em.Point]:
        if self._point is None:
            self._point = ristretto.decode(self._data)
        return self._point

    def verify(self, msg: bytes, sig: bytes, ctx: bytes = SIGNING_CTX) -> bool:
        """sr25519/pubkey.go:35 — s·B == R + k·A."""
        if len(sig) != 64 or not (sig[63] & _MARKER):
            return False
        a = self._decoded()
        if a is None:
            return False
        r_point = ristretto.decode(sig[:32])
        if r_point is None:
            return False
        s_bytes = bytes(sig[32:63]) + bytes([sig[63] & ~_MARKER & 0xFF])
        s = int.from_bytes(s_bytes, "little")
        if s >= em.L:
            return False
        k = _challenge(_signing_transcript(ctx, msg), self._data, sig[:32])
        # s·B − k·A == R  ⇔  k·(−A) + s·B == R  (ristretto base == ed base,
        # so the shared-doubling ladder from the ed25519 path applies)
        lhs = em.double_scalar_mult(k, em.point_neg(a), s)
        return ristretto.equals(lhs, r_point)

    def equals(self, other) -> bool:
        return isinstance(other, Sr25519PubKey) and other._data == self._data

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "value": self._data}

    @classmethod
    def from_dict(cls, d: dict) -> "Sr25519PubKey":
        return cls(d["value"])

    def __repr__(self) -> str:
        return f"Sr25519PubKey({self._data.hex()[:16]})"


class Sr25519PrivKey(PrivKey):
    TYPE = "tendermint/PrivKeySr25519"
    SIZE = 32

    def __init__(self, mini_secret: bytes):
        """The 32 bytes are a schnorrkel MiniSecretKey (what the reference
        stores in PrivKeySr25519), NOT a raw scalar — expansion follows
        ExpandEd25519 so derived pubkeys and signatures are wire-compatible
        with the reference (privkey.go:26-40)."""
        if len(mini_secret) != self.SIZE:
            raise ValueError("sr25519 privkey must be a 32-byte mini secret")
        self._raw = bytes(mini_secret)
        self._scalar, self._nonce = _expand_ed25519(self._raw)
        pub_point = em.scalar_mult(self._scalar, ristretto.BASEPOINT)
        self._pub = Sr25519PubKey(ristretto.encode(pub_point))

    @classmethod
    def generate(cls) -> "Sr25519PrivKey":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_secret(cls, secret: bytes) -> "Sr25519PrivKey":
        import hashlib

        return cls(hashlib.sha256(b"sr25519:" + secret).digest())

    def bytes(self) -> bytes:
        return self._raw

    def pub_key(self) -> Sr25519PubKey:
        return self._pub

    def sign(self, msg: bytes, ctx: bytes = SIGNING_CTX) -> bytes:
        t = _signing_transcript(ctx, msg)
        # deterministic witness bound to the expanded nonce seed +
        # transcript state (schnorrkel derives its witness from the same
        # nonce half of the expanded key; it additionally mixes an OS RNG,
        # which verifiers cannot observe — determinism here is safe and
        # keeps signing reproducible)
        wt = t.clone()
        wt.append_message(b"nonce-seed", self._nonce)
        r = int.from_bytes(wt.challenge_bytes(b"witness", 64), "little") % em.L
        r_bytes = ristretto.encode(em.scalar_mult(r, ristretto.BASEPOINT))
        k = _challenge(t, self._pub.bytes(), r_bytes)
        s = (k * self._scalar + r) % em.L
        s_bytes = bytearray(s.to_bytes(32, "little"))
        s_bytes[31] |= _MARKER
        return r_bytes + bytes(s_bytes)

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "value": self._raw}

    @classmethod
    def from_dict(cls, d: dict) -> "Sr25519PrivKey":
        return cls(d["value"])


register("tm/PubKeySr25519")(Sr25519PubKey)


def batch_verify(pubkeys, msgs, sigs) -> list:
    """Host batch path: one challenge transcript and one double-scalar
    multiplication per signature, on the host (the card's kernels verify
    ed25519 only)."""
    return [
        Sr25519PubKey(pk).verify(m, s) if len(pk) == 32 else False
        for pk, m, s in zip(pubkeys, msgs, sigs)
    ]
