"""K-of-N threshold multisig public keys.

Reference parity: crypto/multisig/threshold_pubkey.go
(PubKeyMultisigThreshold.VerifyBytes) + the compact bit array
(crypto/multisig/bitarray/compact_bit_array.go) marking which sub-keys
signed.  The composite signature here is msgpack of
{"bits": packed_bitarray_bytes, "sigs": [sig, ...]} — deterministic layout,
no amino.  The port's copy of tendermint_tpu/crypto/multisig.py, on the
port's msgpack subset: `bytes()` and `build_multisig_signature` give the
bytes `msgpack.packb` gives, and `verify` reads a signature as
`msgpack.unpackb(sig, raw=False)` does, map keys held to str or bytes as
its strict_map_key default holds them, so both packages give one verdict
on any bytes.
"""

from __future__ import annotations

from typing import List

from ..encoding import msgpack
from ..encoding.codec import register
from ..libs.bitarray import BitArray
from .keys import PubKey, pubkey_from_dict
from .tmhash import sum_truncated


@register("pk/multisig")
class MultisigThresholdPubKey(PubKey):
    TYPE = "tendermint/PubKeyMultisigThreshold"

    def __init__(self, threshold: int, pubkeys: List[PubKey]):
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        if threshold > len(pubkeys):
            raise ValueError("threshold cannot exceed key count")
        self.threshold = threshold
        self.pubkeys = list(pubkeys)

    def address(self) -> bytes:
        return sum_truncated(self.bytes())

    def bytes(self) -> bytes:
        return msgpack.packb(
            {
                "threshold": self.threshold,
                "pubkeys": [pk.to_dict() for pk in self.pubkeys],
            }
        )

    def verify(self, msg: bytes, sig: bytes) -> bool:
        try:
            d = msgpack.unpackb(sig)
            _strict_map_keys(d)
            bits = BitArray.from_bytes(d["bits"])
            sigs: List[bytes] = d["sigs"]
            if not isinstance(sigs, list) or not all(
                isinstance(s, bytes) for s in sigs
            ):
                return False
            if bits.bits != len(self.pubkeys):
                return False
            if bits.count() < self.threshold or bits.count() != len(sigs):
                return False
            si = 0
            for i, pk in enumerate(self.pubkeys):
                if not bits.get_index(i):
                    continue
                if not pk.verify(msg, sigs[si]):
                    return False
                si += 1
            return True
        except Exception:
            # verify() is total over attacker-controlled bytes: any malformed
            # payload is a rejection, never a crash.
            return False

    def to_dict(self) -> dict:
        return {
            "type": self.TYPE,
            "threshold": self.threshold,
            "pubkeys": [pk.to_dict() for pk in self.pubkeys],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MultisigThresholdPubKey":
        return cls(d["threshold"], [pubkey_from_dict(p) for p in d["pubkeys"]])


def _strict_map_keys(obj) -> None:
    """Raise where msgpack's strict_map_key would: a map key that is not
    str or bytes, at any depth."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            _strict_map_keys(v)
    elif isinstance(obj, list):
        for v in obj:
            _strict_map_keys(v)


def build_multisig_signature(bits: BitArray, sigs: List[bytes]) -> bytes:
    return msgpack.packb({"bits": bits.to_bytes(), "sigs": list(sigs)})
