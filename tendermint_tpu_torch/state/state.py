"""State: description of the latest committed block (the port's copy of
tendermint_tpu/state/state.py; per-vote commits only).

Reference parity: state/state.go (State:51, Copy:86, MakeBlock:131,
MakeGenesisState state/state.go:222).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from ..encoding import codec
from ..types.agg_commit import AggregateCommit, weighted_median_timestamp
from ..types.block import Block, BlockID, Commit, Header
from ..types.evidence import evidence_list_hash
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.tx import txs_hash
from ..types.validator import ValidatorSet
from ..version import BLOCK_PROTOCOL, SOFTWARE_VERSION


@dataclass
class State:
    chain_id: str = ""
    version_block: int = BLOCK_PROTOCOL
    version_app: int = 0
    software: str = SOFTWARE_VERSION

    # last_block_height=0 at genesis (block H=0 does not exist)
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0

    # validator sets: next (H+2 delay), current, last (validates LastCommit)
    next_validators: Optional[ValidatorSet] = None
    validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def copy(self) -> "State":
        return replace(
            self,
            next_validators=self.next_validators.copy() if self.next_validators else None,
            validators=self.validators.copy() if self.validators else None,
            last_validators=self.last_validators.copy() if self.last_validators else None,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    def bytes(self) -> bytes:
        return codec.dumps(self)

    def equals(self, other: "State") -> bool:
        return self.bytes() == other.bytes()

    def make_block(
        self,
        height: int,
        txs: List[bytes],
        commit: Optional[Commit],
        evidence: list,
        proposer_address: bytes,
    ) -> Block:
        """Build a proposal block from this state (state/state.go:131).
        Block time is BFT time: genesis time at height 1, else the
        power-weighted median of the last commit's vote timestamps."""
        if height == 1:
            time_ns = self.last_block_time_ns
        else:
            time_ns = median_time(commit, self.last_validators)
        header = Header(
            version_block=self.version_block,
            version_app=self.version_app,
            chain_id=self.chain_id,
            height=height,
            time_ns=time_ns,
            last_block_id=self.last_block_id,
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            data_hash=txs_hash(txs),
            evidence_hash=evidence_list_hash(evidence),
            last_commit_hash=b"",
            proposer_address=proposer_address,
        )
        block = Block(header, txs, evidence=evidence, last_commit=commit)
        block.fill_header()
        return block

    def to_dict(self) -> dict:
        return {
            "chain_id": self.chain_id,
            "version_block": self.version_block,
            "version_app": self.version_app,
            "software": self.software,
            "last_block_height": self.last_block_height,
            "last_block_id": self.last_block_id.to_dict(),
            "last_block_time_ns": self.last_block_time_ns,
            "next_validators": self.next_validators.to_dict() if self.next_validators else None,
            "validators": self.validators.to_dict() if self.validators else None,
            "last_validators": self.last_validators.to_dict() if self.last_validators else None,
            "last_height_validators_changed": self.last_height_validators_changed,
            "consensus_params": self.consensus_params.to_dict(),
            "last_height_consensus_params_changed": self.last_height_consensus_params_changed,
            "last_results_hash": self.last_results_hash,
            "app_hash": self.app_hash,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "State":
        return cls(
            chain_id=d["chain_id"],
            version_block=d["version_block"],
            version_app=d["version_app"],
            software=d["software"],
            last_block_height=d["last_block_height"],
            last_block_id=BlockID.from_dict(d["last_block_id"]),
            last_block_time_ns=d["last_block_time_ns"],
            next_validators=ValidatorSet.from_dict(d["next_validators"]) if d["next_validators"] else None,
            validators=ValidatorSet.from_dict(d["validators"]) if d["validators"] else None,
            last_validators=ValidatorSet.from_dict(d["last_validators"]) if d["last_validators"] else None,
            last_height_validators_changed=d["last_height_validators_changed"],
            consensus_params=ConsensusParams.from_dict(d["consensus_params"]),
            last_height_consensus_params_changed=d["last_height_consensus_params_changed"],
            last_results_hash=d["last_results_hash"],
            app_hash=d["app_hash"],
        )


codec.register("tm/State")(State)


def median_time(commit: Commit, validators: ValidatorSet) -> int:
    """Power-weighted median of commit timestamps (state/state.go:166
    MedianTime; BFT-time spec).  Deterministic across nodes.

    An AggregateCommit carries ONE timestamp, computed at fold time by the
    same weighted-median rule from the per-vote timestamps it summarizes,
    so it is returned as it is.  BLS votes sign timestamp-free bytes, so no
    one can derive that median from signatures again: on all-BLS nets
    block time is proposer-attested, bounded by header monotonicity
    (validate_block) and the propose-side clock-drift prevote gate."""
    if isinstance(commit, AggregateCommit):
        return commit.timestamp_ns
    return weighted_median_timestamp(commit, validators)


def make_genesis_state(gen_doc: GenesisDoc) -> State:
    """state/state.go:222 MakeGenesisState."""
    gen_doc.validate_and_complete()
    if gen_doc.validators:
        val_set = gen_doc.validator_set()
        next_val_set = val_set.copy_increment_proposer_priority(1)
    else:
        # validators come from the app's InitChain response
        val_set = ValidatorSet()
        next_val_set = ValidatorSet()
    return State(
        chain_id=gen_doc.chain_id,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time_ns=gen_doc.genesis_time_ns,
        next_validators=next_val_set,
        validators=val_set,
        last_validators=ValidatorSet(),
        last_height_validators_changed=1,
        consensus_params=gen_doc.consensus_params,
        last_height_consensus_params_changed=1,
        app_hash=gen_doc.app_hash,
    )
