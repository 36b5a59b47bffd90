"""Node identity key: the port's copy of tendermint_tpu/p2p/key.py.

Reference parity: p2p/key.go (NodeKey; ID = hex of address of ed25519
pubkey, p2p/key.go:38) — node ID is derived from the identity key, which
also signs the secret-connection challenge.  The file's JSON is the JAX
package's byte for byte.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey


def node_id_from_pubkey(pub_key: Ed25519PubKey) -> str:
    return pub_key.address().hex()


@dataclass
class NodeKey:
    priv_key: Ed25519PrivKey

    @property
    def id(self) -> str:
        return node_id_from_pubkey(self.priv_key.pub_key())

    def pub_key(self) -> Ed25519PubKey:
        return self.priv_key.pub_key()

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(Ed25519PrivKey.generate())

    def save_as(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"priv_key": {"type": "ed25519", "value": self.priv_key.bytes().hex()}}, f)

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            d = json.load(f)
        return cls(Ed25519PrivKey(bytes.fromhex(d["priv_key"]["value"])))

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls.generate()
        nk.save_as(path)
        return nk
