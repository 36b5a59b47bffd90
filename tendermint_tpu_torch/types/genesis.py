"""Genesis document: the port's copy of tendermint_tpu/types/genesis.py.
Validators carry any key type the port has (ed25519, sr25519, secp256k1,
bls12381); every BLS12-381 validator must carry a valid proof of
possession, checked in one batch.

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
    # BLS12-381 proof of possession (96B signature over the pubkey, DST
    # BLS_POP_*).  REQUIRED for BLS validators: FastAggregateVerify — the
    # single pairing check behind aggregate commits — is only sound against
    # rogue-key attacks when every key in the set proved possession, and
    # genesis is where this framework's validator keys enter the set.
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
        self._validate_bls_pops()
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = time.time_ns()

    def _validate_bls_pops(self) -> None:
        """Every BLS12-381 validator must carry a VALID proof of
        possession.  FastAggregateVerify — the single pairing check behind
        aggregate commits — is only sound against rogue-key attacks for
        PoP-checked key sets, and genesis is the ONLY door BLS keys have
        into a validator set besides ABCI updates, which carry their own
        proof (state/execution.py)."""
        from .vote import is_bls_key

        bls = [v for v in self.validators if is_bls_key(v.pub_key)]
        if not bls:
            return
        for v in bls:
            if not v.pop:
                raise ValueError(
                    f"BLS validator {v.name or v.address.hex()} has no proof of "
                    "possession; aggregate verification would be rogue-key-forgeable"
                )
        from ..crypto.bls import scheme

        if scheme.batch_pop_verify([(v.pub_key.bytes(), v.pop) for v in bls]):
            return
        for v in bls:  # attribute the liar
            if not scheme.pop_verify(v.pub_key.bytes(), v.pop):
                raise ValueError(
                    f"invalid BLS proof of possession for validator "
                    f"{v.name or v.address.hex()}"
                )
        raise ValueError("BLS proof-of-possession batch check failed")

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
