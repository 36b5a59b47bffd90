"""BlockExecutor: the commit pipeline (the port's copy of
tendermint_tpu/state/execution.py).

Reference parity: state/execution.go (BlockExecutor:23, ApplyBlock:126,
CreateProposalBlock:92, Commit:197, execBlockOnProxyApp:248,
updateState:384, fireEvents:449, ExecCommitBlock:488).
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

from ..abci import types as abci
from ..crypto.keys import Ed25519PubKey
from ..libs.fail import fail_point
from ..libs.log import get_logger
from ..types.block import Block, BlockID, Commit
from ..types.tx import results_hash, ABCIResult
from ..types.params import max_evidence_per_block, MAX_VOTE_BYTES, MAX_HEADER_BYTES, MAX_OVERHEAD_FOR_BLOCK, MAX_EVIDENCE_BYTES
from ..types.validator import Validator
from .state import State
from .store import StateStore
from .validation import InvalidBlockError, validate_block


def validator_updates_from_abci(updates: List[abci.ValidatorUpdate]) -> List[Validator]:
    """types/protobuf.go PB2TM.ValidatorUpdates.

    ed25519 and bls12381 keys are admitted.  A BLS key with non-zero power
    MUST carry a proof of possession (`vu.pop`): FastAggregateVerify —
    what fold_commit/agg_commit rely on once a set goes uniform-BLS — is
    rogue-key-sound only over PoP-checked keys, and the genesis PoP gate
    (types/genesis.py:_validate_bls_pops) never sees ABCI-driven joins.
    Removals (power 0) skip the check: the key is leaving, not signing.
    """
    out = []
    for vu in updates:
        if vu.pub_key_type == "ed25519":
            pk = Ed25519PubKey(vu.pub_key)
        elif vu.pub_key_type == "bls12381":
            from ..crypto.bls.keys import BlsPubKey

            pk = BlsPubKey(vu.pub_key)
            if vu.power != 0:
                if not vu.pop:
                    raise ValueError(
                        f"bls12381 validator update {vu.pub_key.hex()[:16]} "
                        "lacks a proof of possession"
                    )
                if not pk.verify_pop(vu.pop):
                    raise ValueError(
                        f"bls12381 validator update {vu.pub_key.hex()[:16]} "
                        "has an invalid proof of possession"
                    )
        else:
            raise ValueError(f"unsupported pubkey type {vu.pub_key_type}")
        out.append(Validator(pk.address(), pk, vu.power))
    return out


def validate_validator_updates(updates: List[abci.ValidatorUpdate], params) -> None:
    """state/execution.go:362."""
    for vu in updates:
        if vu.power < 0:
            raise ValueError(f"voting power can't be negative: {vu}")
        if vu.power == 0:
            continue
        if not params.is_valid_pubkey_type(vu.pub_key_type):
            raise ValueError(
                f"validator {vu} is using pubkey {vu.pub_key_type}, unsupported for consensus"
            )


def max_data_bytes(max_bytes: int, vals_count: int, evidence_count: int) -> int:
    """types/block.go:273 MaxDataBytes."""
    md = (
        max_bytes
        - MAX_OVERHEAD_FOR_BLOCK
        - MAX_HEADER_BYTES
        - vals_count * MAX_VOTE_BYTES
        - evidence_count * MAX_EVIDENCE_BYTES
    )
    if md < 0:
        raise ValueError(f"negative MaxDataBytes: block max_bytes {max_bytes} too small")
    return md


class BlockExecutor:
    """Validates, executes (over the ABCI consensus connection), commits,
    and persists blocks (state/execution.go:23)."""

    def __init__(
        self,
        state_store: StateStore,
        proxy_app,  # abci Client (consensus connection)
        mempool,
        evidence_pool=None,
        event_bus=None,
        metrics=None,
    ):
        self.state_store = state_store
        self.proxy_app = proxy_app
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.metrics = metrics
        self.log = get_logger("state")

    # -- proposal creation -------------------------------------------------
    def create_proposal_block(
        self, height: int, state: State, commit: Optional[Commit], proposer_address: bytes
    ) -> Block:
        """state/execution.go:92."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        max_num_evidence, _ = max_evidence_per_block(max_bytes)
        evidence = (
            self.evidence_pool.pending_evidence(max_num_evidence) if self.evidence_pool else []
        )
        md = max_data_bytes(max_bytes, state.validators.size(), len(evidence))
        txs = self.mempool.reap_max_bytes_max_gas(md, max_gas)
        return state.make_block(height, txs, commit, evidence, proposer_address)

    # -- validation --------------------------------------------------------
    def validate_block(self, state: State, block: Block) -> None:
        validate_block(state, block, self.state_store, self.evidence_pool)

    # -- the commit pipeline ----------------------------------------------
    async def apply_block(
        self, state: State, block_id: BlockID, block: Block
    ) -> Tuple[State, int]:
        """state/execution.go:126 ApplyBlock: validate → exec over ABCI →
        save responses → validator updates → commit+mempool update →
        save state → fire events.  Returns (new_state, retain_height)."""
        self.validate_block(state, block)

        import time as _time

        _t0 = _time.perf_counter()
        abci_responses = await self._exec_block_on_proxy_app(state, block)
        if self.metrics is not None:
            self.metrics.block_processing_time.observe((_time.perf_counter() - _t0) * 1000)
        fail_point("applyblock-saved-responses")
        self.state_store.save_abci_responses(block.height, _responses_to_dict(abci_responses))
        fail_point("applyblock-validated-updates")

        end_block: abci.ResponseEndBlock = abci_responses["end_block"]
        validate_validator_updates(end_block.validator_updates, state.consensus_params.validator)
        validator_updates = validator_updates_from_abci(end_block.validator_updates)
        if validator_updates:
            self.log.info("updates to validators", n=len(validator_updates))

        state = update_state(state, block_id, block, abci_responses, validator_updates)

        app_hash, retain_height = await self.commit(state, block, abci_responses["deliver_txs"])

        if self.evidence_pool is not None:
            self.evidence_pool.update(block, state)
        fail_point("applyblock-committed")

        state = replace(state, app_hash=app_hash)
        self.state_store.save(state)
        fail_point("applyblock-saved-state")

        await self._fire_events(block, abci_responses, validator_updates)
        return state, retain_height

    async def commit(
        self, state: State, block: Block, deliver_tx_responses: List[abci.ResponseDeliverTx]
    ) -> Tuple[bytes, int]:
        """Lock mempool, flush app conn, ABCI Commit, mempool.update
        (state/execution.go:197)."""
        async with self.mempool.lock():
            await self.mempool.flush_app_conn()
            res = await self.proxy_app.commit()
            self.log.info(
                "committed state",
                height=block.height,
                txs=len(block.txs),
                app_hash=res.data.hex()[:16],
            )
            await self.mempool.update(
                block.height,
                block.txs,
                deliver_tx_responses,
                tx_pre_check(state),
                None,
            )
        return res.data, res.retain_height

    async def _exec_block_on_proxy_app(self, state: State, block: Block) -> dict:
        """BeginBlock → DeliverTx×N → EndBlock (state/execution.go:248)."""
        commit_info = self._begin_block_validator_info(state, block)
        begin = await self.proxy_app.begin_block(
            abci.RequestBeginBlock(
                hash=block.hash(),
                header=block.header.to_dict(),
                last_commit_info=commit_info,
                byzantine_validators=[
                    {
                        "height": ev.height(),
                        "time_ns": ev.time_ns(),
                        "address": ev.address(),
                    }
                    for ev in block.evidence
                ],
            )
        )
        deliver_txs = []
        valid = invalid = 0
        for tx in block.txs:
            r = await self.proxy_app.deliver_tx(abci.RequestDeliverTx(tx=tx))
            if r.code == abci.CODE_TYPE_OK:
                valid += 1
            else:
                invalid += 1
            deliver_txs.append(r)
        end = await self.proxy_app.end_block(abci.RequestEndBlock(height=block.height))
        self.log.info("executed block", height=block.height, valid_txs=valid, invalid_txs=invalid)
        return {"begin_block": begin, "deliver_txs": deliver_txs, "end_block": end}

    def _begin_block_validator_info(self, state: State, block: Block) -> abci.LastCommitInfo:
        """state/execution.go:314 getBeginBlockValidatorInfo."""
        votes = []
        if block.height > 1:
            if block.height - 1 == state.last_block_height:
                # Live path: the set is already in hand.  The store load
                # fast-forwards proposer priority by (height − last_changed)
                # — O(height) per block with a static validator set, i.e.
                # O(height²) over a run — and LastCommitInfo only reads
                # address/power/absence, which priorities never affect.
                last_val_set = state.last_validators
            else:
                last_val_set = self.state_store.load_validators(block.height - 1)
            if last_val_set is None:
                last_val_set = state.last_validators
            if block.last_commit.size() != last_val_set.size():
                raise InvalidBlockError(
                    f"commit size ({block.last_commit.size()}) doesn't match valset length "
                    f"({last_val_set.size()}) at height {block.height}"
                )
            for i, val in enumerate(last_val_set.validators):
                cs = block.last_commit.signatures[i]
                votes.append(
                    {
                        "address": val.address,
                        "power": val.voting_power,
                        "signed_last_block": not cs.is_absent(),
                    }
                )
        round_ = block.last_commit.round if block.last_commit else 0
        return abci.LastCommitInfo(round=round_, votes=votes)

    async def _fire_events(self, block: Block, abci_responses: dict, validator_updates) -> None:
        """state/execution.go:449.  Publication must never stall or break
        the commit path: fan-out goes through the pubsub's bounded
        per-subscriber queues (put_nowait; a subscriber that stops
        draining is cancelled "out of capacity" — libs/events), and any
        publication failure is logged, not raised — a broken subscriber
        pipe is not a consensus fault."""
        if self.event_bus is None:
            return
        try:
            await self.event_bus.publish_new_block(
                block, abci_responses["begin_block"], abci_responses["end_block"]
            )
            await self.event_bus.publish_new_block_header(block.header)
            for i, tx in enumerate(block.txs):
                r = abci_responses["deliver_txs"][i]
                events = _abci_events_to_map(r.events)
                await self.event_bus.publish_tx(
                    block.height, i, tx, {"code": r.code, "data": r.data, "log": r.log}, events
                )
            if validator_updates:
                await self.event_bus.publish_validator_set_updates(validator_updates)
        except Exception as e:
            self.log.error("event publication failed", height=block.height, err=repr(e))

    # -- fast-sync variant -------------------------------------------------
    async def exec_commit_block(self, state: State, block: Block) -> bytes:
        """Execute + commit without validation/state mutation
        (state/execution.go:488; used by handshake replay)."""
        await self._exec_block_on_proxy_app(state, block)
        res = await self.proxy_app.commit()
        return res.data


def _abci_events_to_map(events: List[abci.Event]) -> dict:
    out: dict = {}
    for ev in events:
        for attr in ev.attributes:
            key = attr["key"]
            if isinstance(key, bytes):
                key = key.decode(errors="replace")
            value = attr.get("value", b"")
            if isinstance(value, bytes):
                value = value.decode(errors="replace")
            out.setdefault(f"{ev.type}.{key}", []).append(value)
    return out


def _responses_to_dict(responses: dict) -> dict:
    from dataclasses import asdict

    return {
        "begin_block": asdict(responses["begin_block"]),
        "deliver_txs": [asdict(r) for r in responses["deliver_txs"]],
        "end_block": asdict(responses["end_block"]),
    }


def abci_results_hash(deliver_txs: List[abci.ResponseDeliverTx]) -> bytes:
    return results_hash([ABCIResult(r.code, r.data) for r in deliver_txs])


def update_state(
    state: State,
    block_id: BlockID,
    block: Block,
    abci_responses: dict,
    validator_updates: List[Validator],
) -> State:
    """state/execution.go:384 updateState."""
    n_val_set = state.next_validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    if validator_updates:
        n_val_set.update_with_change_set(validator_updates)
        # takes effect at H+2 (nextValSet delay)
        last_height_vals_changed = block.height + 1 + 1
    n_val_set.increment_proposer_priority(1)

    next_params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    end_block = abci_responses["end_block"]
    if end_block.consensus_param_updates:
        next_params = state.consensus_params.update(end_block.consensus_param_updates)
        next_params.validate()
        last_height_params_changed = block.height + 1

    return replace(
        state,
        last_block_height=block.height,
        last_block_id=block_id,
        last_block_time_ns=block.time_ns,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=next_params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=abci_results_hash(abci_responses["deliver_txs"]),
        app_hash=b"",
    )


def provisional_next_state(state: State, block_id: BlockID, block: Block) -> State:
    """The delivery-independent slice of update_state: everything height
    H+1's round machinery can know before H's ABCI responses exist, so
    the pipelined consensus lane can advance while delivery runs.

    Validator rotation is fully pre-knowable: update_state promotes
    `next_validators` verbatim (no priority touch) into `validators`, and
    EndBlock updates only land in the NEW next_validators (effective
    H+2) — so H+1's proposer selection under this state is identical to
    the delivered one.  app_hash, last_results_hash, validator updates
    and consensus-param updates ARE delivery outputs: they stay at their
    pre-knowable placeholders and the awaiter swaps in the delivered
    state wholesale before anyone reads them."""
    n_val_set = state.next_validators.copy()
    n_val_set.increment_proposer_priority(1)
    return replace(
        state,
        last_block_height=block.height,
        last_block_id=block_id,
        last_block_time_ns=block.time_ns,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_results_hash=b"",
        app_hash=b"",
    )


def tx_pre_check(state: State):
    """mempool pre-check: tx fits in a block (state/tx_filter.go)."""
    md = max_data_bytes(
        state.consensus_params.block.max_bytes, state.validators.size(), 0
    )

    def check(tx: bytes) -> Optional[str]:
        if len(tx) > md:
            return f"tx too large: {len(tx)} > {md}"
        return None

    return check
