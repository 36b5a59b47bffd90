"""Crash recovery: WAL catchup replay + ABCI handshake block replay (the
port's copy of tendermint_tpu/consensus/replay.py).

Reference parity: consensus/replay.go (catchupReplay:100,
readReplayMessage:45, Handshaker:200, Handshake:241, ReplayBlocks:285,
replayBlock:472, mockProxyApp:516).
"""

from __future__ import annotations

from ..abci import types as abci
from ..libs.log import get_logger
from ..state.state import State as SMState
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import Vote
from ..version import BLOCK_PROTOCOL, P2P_PROTOCOL, SOFTWARE_VERSION

log = get_logger("consensus-replay")


# ---------------------------------------------------------------------------
# WAL catchup (the unfinished height)
# ---------------------------------------------------------------------------


async def catchup_replay(cs, cs_height: int) -> None:
    """Replay WAL records after EndHeight(cs_height-1) through the state
    machine (consensus/replay.go:100).  No re-signing, no WAL re-writes."""
    # guard: we must NOT have an end-height marker for cs_height itself
    records, found = cs.wal.search_for_end_height(cs_height)
    if found:
        raise RuntimeError(f"WAL should not contain #ENDHEIGHT {cs_height}")

    records, found = cs.wal.search_for_end_height(cs_height - 1)
    if records is None and cs_height > 1 and not found:
        raise RuntimeError(f"cannot replay height {cs_height}: WAL has no #ENDHEIGHT {cs_height - 1}")
    if records is None:
        return

    cs.replay_mode = True
    real_wal = cs.wal
    from .wal import NilWAL

    cs.wal = NilWAL()  # don't re-log replayed messages
    try:
        for rec in records:
            await _replay_record(cs, rec)
    finally:
        cs.wal = real_wal
        cs.replay_mode = False
    log.info("replay: done", height=cs_height, records=len(records))


async def _replay_record(cs, rec: dict) -> None:
    """consensus/replay.go:45 readReplayMessage dispatch."""
    kind = rec.get("type")
    if kind == "roundstate":
        return  # informational; new round steps are recomputed
    if kind == "timeout":
        from .ticker import TimeoutInfo

        ti = TimeoutInfo(rec["duration"], rec["height"], rec["round"], rec["step"])
        await cs._handle_timeout(ti)
        return
    if kind == "msg":
        msg = rec["msg"]
        mk = msg["type"]
        if mk == "vote":
            await cs._handle_msg(
                {"type": "vote", "vote": Vote.from_dict(msg["vote"]), "peer_id": rec.get("peer_id", "")}
            )
        elif mk == "proposal":
            await cs._handle_msg(
                {
                    "type": "proposal",
                    "proposal": Proposal.from_dict(msg["proposal"]),
                    "peer_id": rec.get("peer_id", ""),
                }
            )
        elif mk == "block_part":
            await cs._handle_msg(
                {
                    "type": "block_part",
                    "height": msg["height"],
                    "round": msg["round"],
                    "part": Part.from_dict(msg["part"]),
                    "peer_id": rec.get("peer_id", ""),
                }
            )
        return
    if kind == "endheight":
        return


# ---------------------------------------------------------------------------
# ABCI handshake
# ---------------------------------------------------------------------------


class _StoredResponsesApp(abci.Application):
    """Replays saved DeliverTx/EndBlock responses instead of re-executing —
    the reference's mockProxyApp (consensus/replay.go:516), used when the
    app already has the block but our state doesn't."""

    def __init__(self, app_hash: bytes, responses: dict):
        self.app_hash = app_hash
        self.responses = responses
        self._tx_i = 0

    def begin_block(self, req):
        bb = self.responses.get("begin_block") or {}
        return abci.ResponseBeginBlock(**_only_fields(abci.ResponseBeginBlock, bb))

    def deliver_tx(self, req):
        r = self.responses["deliver_txs"][self._tx_i]
        self._tx_i += 1
        return abci.ResponseDeliverTx(**_only_fields(abci.ResponseDeliverTx, r))

    def end_block(self, req):
        eb = self.responses.get("end_block") or {}
        d = _only_fields(abci.ResponseEndBlock, eb)
        vus = d.get("validator_updates") or []
        d["validator_updates"] = [
            abci.ValidatorUpdate(**vu) if isinstance(vu, dict) else vu for vu in vus
        ]
        return abci.ResponseEndBlock(**d)

    def commit(self, req=None):
        return abci.ResponseCommit(data=self.app_hash)


def _only_fields(cls, d: dict) -> dict:
    import dataclasses

    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


class Handshaker:
    """consensus/replay.go:200 — syncs the app with the block store on
    startup by replaying committed blocks."""

    def __init__(self, state_store, state: SMState, block_store, genesis_doc):
        self.state_store = state_store
        self.initial_state = state
        self.block_store = block_store
        self.genesis_doc = genesis_doc
        self.n_blocks = 0
        self.log = log

    async def handshake(self, proxy_app) -> SMState:
        """Handshake (replay.go:241): Info → ReplayBlocks.  Returns the
        possibly-updated state."""
        res = await proxy_app.query().info(
            abci.RequestInfo(
                version=SOFTWARE_VERSION, block_version=BLOCK_PROTOCOL, p2p_version=P2P_PROTOCOL
            )
        )
        block_height = res.last_block_height
        if block_height < 0:
            raise RuntimeError(f"got negative last block height {block_height} from app")
        app_hash = res.last_block_app_hash
        self.log.info("ABCI handshake", app_height=block_height, app_hash=app_hash.hex()[:16])

        state = await self.replay_blocks(self.initial_state, app_hash, block_height, proxy_app)
        self.log.info(
            "completed ABCI handshake",
            app_height=block_height,
            n_blocks_replayed=self.n_blocks,
        )
        return state

    async def replay_blocks(
        self, state: SMState, app_hash: bytes, app_block_height: int, proxy_app
    ) -> SMState:
        """replay.go:285."""
        store_height = self.block_store.height()
        state_height = state.last_block_height

        # genesis: tell the app about it
        if app_block_height == 0:
            # per-validator key type (a BLS genesis must not be announced
            # to the app as ed25519) + the genesis PoP so a staking-style
            # app can round-trip the full update through end_block later
            _ABCI_KEY_TYPE = {
                "tendermint/PubKeyEd25519": "ed25519",
                "tendermint/PubKeySr25519": "sr25519",
                "tendermint/PubKeySecp256k1": "secp256k1",
                "tendermint/PubKeyBLS12381": "bls12381",
            }
            validators = [
                abci.ValidatorUpdate(
                    _ABCI_KEY_TYPE.get(getattr(v.pub_key, "TYPE", ""), "ed25519"),
                    v.pub_key.bytes(),
                    v.power,
                    pop=getattr(v, "pop", b"") or b"",
                )
                for v in self.genesis_doc.validators
            ]
            app_state_bytes = b""
            if self.genesis_doc.app_state is not None:
                import json as _json

                app_state_bytes = _json.dumps(
                    self.genesis_doc.app_state, sort_keys=True
                ).encode()
            req = abci.RequestInitChain(
                time_ns=self.genesis_doc.genesis_time_ns,
                chain_id=self.genesis_doc.chain_id,
                consensus_params=self.genesis_doc.consensus_params.to_dict(),
                validators=validators,
                app_state_bytes=app_state_bytes,
            )
            res = await proxy_app.consensus().init_chain(req)
            if state_height == 0:  # only apply on a truly new chain
                from dataclasses import replace

                from ..state.execution import validator_updates_from_abci
                from ..types.validator import ValidatorSet

                app_hash = b""
                if res.validators:
                    vals = validator_updates_from_abci(res.validators)
                    val_set = ValidatorSet(vals)
                    state = replace(
                        state,
                        validators=val_set,
                        next_validators=val_set.copy_increment_proposer_priority(1),
                    )
                elif not self.genesis_doc.validators:
                    raise RuntimeError("validator set is nil in genesis and still empty after InitChain")
                if res.consensus_params:
                    state = replace(
                        state,
                        consensus_params=state.consensus_params.update(res.consensus_params),
                    )
                self.state_store.save(state)

        # first handle edge cases (replay.go:340)
        if store_height == 0:
            _assert_app_hash_eq(app_hash, state.app_hash)
            return state
        if store_height < app_block_height:
            raise RuntimeError(
                f"app block height {app_block_height} ahead of store {store_height}"
            )
        if store_height < state_height:
            raise RuntimeError(
                f"state height {state_height} ahead of store {store_height}"
            )
        if store_height > state_height + 1:
            raise RuntimeError(
                f"store height {store_height} more than one ahead of state {state_height}"
            )

        if store_height == state_height:
            # replay (store) blocks the app is missing; app may equal store
            if app_block_height < store_height:
                return await self._replay_range(state, proxy_app, app_block_height, store_height, False)
            _assert_app_hash_eq(app_hash, state.app_hash)
            return state

        # store_height == state_height + 1: crashed between SaveBlock and state save
        if app_block_height < state_height:
            # app even further behind: replay up to store-1, then apply last
            state = await self._replay_range(state, proxy_app, app_block_height, store_height - 1, True)
            return await self._apply_block(state, proxy_app.consensus(), store_height)
        if app_block_height == state_height:
            # app is at the state height: apply the final block normally
            return await self._apply_block(state, proxy_app.consensus(), store_height)
        if app_block_height == store_height:
            # app already has the final block: update our state using the
            # saved ABCI responses without re-executing
            responses = self.state_store.load_abci_responses(store_height)
            if responses is None:
                raise RuntimeError(f"no saved ABCI responses for height {store_height}")
            from ..abci.client import LocalClient

            mock = LocalClient(_StoredResponsesApp(app_hash, responses))
            await mock.start()
            state = await self._apply_block(state, mock, store_height)
            return state
        raise RuntimeError(
            f"unexpected heights: store={store_height} state={state_height} app={app_block_height}"
        )

    async def _replay_range(
        self, state: SMState, proxy_app, app_block_height: int, finish_height: int, mutate_last: bool
    ) -> SMState:
        """Replay stored blocks into the app via exec-commit
        (replay.go:418 replayBlocks inner loop)."""
        from ..state.execution import BlockExecutor
        from ..mempool import NopMempool

        app_hash = b""
        first = app_block_height + 1
        executor = BlockExecutor(self.state_store, proxy_app.consensus(), NopMempool())
        for height in range(first, finish_height + 1):
            self.log.info("applying block against app", height=height)
            block = self.block_store.load_block(height)
            app_hash = await executor.exec_commit_block(state, block)
            self.n_blocks += 1
        _assert_app_hash_eq(app_hash, state.app_hash)
        return state

    async def _apply_block(self, state: SMState, app_conn, height: int) -> SMState:
        """replay.go:472 replayBlock — full ApplyBlock so state advances."""
        from ..mempool import NopMempool
        from ..state.execution import BlockExecutor

        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        executor = BlockExecutor(self.state_store, app_conn, NopMempool())
        state, _ = await executor.apply_block(state, meta.block_id, block)
        self.n_blocks += 1
        return state


def _assert_app_hash_eq(app_hash: bytes, expected: bytes) -> None:
    """replay.go:490 checkAppHash — mismatch means the app changed
    non-deterministically; halt loudly."""
    if expected and app_hash != expected:
        raise RuntimeError(
            f"app hash mismatch: state has {expected.hex()}, app returned {app_hash.hex()}"
        )
