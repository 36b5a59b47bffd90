"""Stateful block validation (the port's copy of
tendermint_tpu/state/validation.py).

Reference parity: state/validation.go (validateBlock:17, VerifyEvidence:156).
The LastCommit check routes through the batched verifier: on the card it
takes the indexed path (TableCache, then the auto-profile's kernel).
"""

from __future__ import annotations

from typing import Optional

from ..types.block import ADDRESS_SIZE, Block
from ..types.params import max_evidence_per_block
from .state import State, median_time


class InvalidBlockError(Exception):
    pass


def validate_block(state: State, block: Block, state_store=None, evidence_pool=None) -> None:
    try:
        block.validate_basic()
    except ValueError as e:
        raise InvalidBlockError(str(e)) from e

    h = block.header
    if h.version_block != state.version_block:
        raise InvalidBlockError(
            f"wrong Block.Header.Version: expected {state.version_block}, got {h.version_block}"
        )
    if h.chain_id != state.chain_id:
        raise InvalidBlockError(
            f"wrong Block.Header.ChainID: expected {state.chain_id}, got {h.chain_id}"
        )
    if h.height != state.last_block_height + 1:
        raise InvalidBlockError(
            f"wrong Block.Header.Height: expected {state.last_block_height + 1}, got {h.height}"
        )
    if h.last_block_id != state.last_block_id:
        raise InvalidBlockError(
            f"wrong Block.Header.LastBlockID: expected {state.last_block_id}, got {h.last_block_id}"
        )
    if h.app_hash != state.app_hash:
        raise InvalidBlockError(
            f"wrong Block.Header.AppHash: expected {state.app_hash.hex()}, got {h.app_hash.hex()}"
        )
    if h.consensus_hash != state.consensus_params.hash():
        raise InvalidBlockError("wrong Block.Header.ConsensusHash")
    if h.last_results_hash != state.last_results_hash:
        raise InvalidBlockError("wrong Block.Header.LastResultsHash")
    if h.validators_hash != state.validators.hash():
        raise InvalidBlockError("wrong Block.Header.ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash():
        raise InvalidBlockError("wrong Block.Header.NextValidatorsHash")

    # LastCommit — batched signature verification
    if block.height == 1:
        if block.last_commit is not None and block.last_commit.signatures:
            raise InvalidBlockError("block at height 1 can't have LastCommit signatures")
    else:
        if block.last_commit.size() != state.last_validators.size():
            raise InvalidBlockError(
                f"invalid commit size: expected {state.last_validators.size()}, "
                f"got {block.last_commit.size()}"
            )
        try:
            state.last_validators.verify_commit(
                state.chain_id, state.last_block_id, block.height - 1, block.last_commit
            )
        except ValueError as e:
            raise InvalidBlockError(str(e)) from e

    # BFT time
    if block.height > 1:
        if block.time_ns <= state.last_block_time_ns:
            raise InvalidBlockError(
                f"block time {block.time_ns} not greater than last block time "
                f"{state.last_block_time_ns}"
            )
        expected = median_time(block.last_commit, state.last_validators)
        if block.time_ns != expected:
            raise InvalidBlockError(
                f"invalid block time: expected {expected}, got {block.time_ns}"
            )
    elif block.height == 1:
        if block.time_ns != state.last_block_time_ns:
            raise InvalidBlockError(
                f"block time {block.time_ns} is not equal to genesis time "
                f"{state.last_block_time_ns}"
            )

    # evidence
    max_num, _ = max_evidence_per_block(state.consensus_params.block.max_bytes)
    if len(block.evidence) > max_num:
        raise InvalidBlockError(f"too much evidence: max {max_num}, got {len(block.evidence)}")
    for ev in block.evidence:
        try:
            verify_evidence(state, ev, state_store)
        except (ValueError, InvalidBlockError) as e:
            raise InvalidBlockError(f"invalid evidence: {e}") from e
        if evidence_pool is not None and evidence_pool.is_committed(ev):
            raise InvalidBlockError("evidence was already committed")

    if len(h.proposer_address) != ADDRESS_SIZE or not state.validators.has_address(
        h.proposer_address
    ):
        raise InvalidBlockError(
            f"block.Header.ProposerAddress {h.proposer_address.hex()} is not a validator"
        )


def verify_evidence(state: State, evidence, state_store=None) -> None:
    """state/validation.go:156 VerifyEvidence: recency, validator-at-height
    membership, internal consistency, signatures."""
    height = state.last_block_height
    params = state.consensus_params.evidence

    age_num_blocks = height - evidence.height()
    if age_num_blocks > params.max_age_num_blocks:
        raise ValueError(
            f"evidence from height {evidence.height()} is too old; "
            f"min height is {height - params.max_age_num_blocks}"
        )
    age_ns = state.last_block_time_ns - evidence.time_ns()
    if age_ns > params.max_age_duration_ns:
        raise ValueError(f"evidence created at {evidence.time_ns()} has expired")

    valset: Optional = None
    if state_store is not None:
        valset = state_store.load_validators(evidence.height())
    if valset is None:
        # The reference errors here (state/validation.go evidence path):
        # validating against the wrong-era set would accept equivocation by
        # someone who was not a validator at evidence.height, or reject
        # evidence against someone who was.
        raise ValueError(
            f"no validator set stored for evidence height {evidence.height()}"
        )
    _, val = valset.get_by_address(evidence.address())
    if val is None:
        raise ValueError(
            f"address {evidence.address().hex()} was not a validator at height {evidence.height()}"
        )
    evidence.verify(state.chain_id, val.pub_key)
