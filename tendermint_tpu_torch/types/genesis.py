"""Genesis document: the port's copy of tendermint_tpu/types/genesis.py.
Validators carry any key type the port has (ed25519, sr25519, secp256k1;
pubkey_from_dict raises TypeError on bls12381, ROADMAP 1.9), so the BLS
proof-of-possession check has nothing to check; the `pop` field keeps the
JSON layout.

Reference parity: types/genesis.go (GenesisValidator:31, GenesisDoc:38,
ValidateAndComplete:67).
"""

from __future__ import annotations

import base64
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..crypto.keys import PubKey, pubkey_from_dict
from .params import MAX_CHAIN_ID_LEN, ConsensusParams
from .validator import Validator, ValidatorSet


@dataclass
class GenesisValidator:
    address: bytes
    pub_key: PubKey
    power: int
    name: str = ""
    # BLS12-381 proof of possession in the JAX package's layout; BLS keys
    # are not ported (ROADMAP 1.9)
    pop: bytes = b""

    def to_dict(self) -> dict:
        pk = self.pub_key.to_dict()
        d = {
            "address": self.address.hex().upper(),
            "pub_key": {"type": pk["type"], "value": base64.b64encode(pk["value"]).decode()},
            "power": str(self.power),
            "name": self.name,
        }
        if self.pop:
            d["pop"] = base64.b64encode(self.pop).decode()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "GenesisValidator":
        pk = pubkey_from_dict(
            {"type": d["pub_key"]["type"], "value": base64.b64decode(d["pub_key"]["value"])}
        )
        addr = bytes.fromhex(d["address"]) if d.get("address") else b""
        return cls(
            address=addr,
            pub_key=pk,
            power=int(d["power"]),
            name=d.get("name", ""),
            pop=base64.b64decode(d["pop"]) if d.get("pop") else b"",
        )


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    consensus_params: Optional[ConsensusParams] = None
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: Optional[dict] = None

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet([Validator.new(v.pub_key, v.power) for v in self.validators])

    def validator_hash(self) -> bytes:
        return self.validator_set().hash()

    def validate_and_complete(self) -> None:
        """types/genesis.go:67."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max: {MAX_CHAIN_ID_LEN})")
        if self.consensus_params is None:
            self.consensus_params = ConsensusParams()
        else:
            self.consensus_params.validate()
        for v in self.validators:
            if v.power == 0:
                raise ValueError(f"genesis file cannot contain validators with no voting power: {v}")
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(f"incorrect address for validator {v} in the genesis file")
            if not v.address:
                v.address = v.pub_key.address()
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = time.time_ns()

    # -- JSON file round-trip ---------------------------------------------
    def to_json(self) -> str:
        doc = {
            "genesis_time_ns": self.genesis_time_ns,
            "chain_id": self.chain_id,
            "consensus_params": self.consensus_params.to_dict() if self.consensus_params else None,
            "validators": [v.to_dict() for v in self.validators],
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.app_state is not None:
            doc["app_state"] = self.app_state
        return json.dumps(doc, indent=2, sort_keys=True)

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, blob: str) -> "GenesisDoc":
        d = json.loads(blob)
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time_ns=d.get("genesis_time_ns", 0),
            consensus_params=(
                ConsensusParams.from_dict(d["consensus_params"]) if d.get("consensus_params") else None
            ),
            validators=[GenesisValidator.from_dict(v) for v in d.get("validators", [])],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=d.get("app_state"),
        )
        doc.validate_and_complete()
        return doc

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
