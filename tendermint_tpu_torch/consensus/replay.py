"""Crash recovery, the ABCI handshake half: block replay into the app at
startup (the port's copy of the Handshaker of
tendermint_tpu/consensus/replay.py).  The WAL catchup replay of an
unfinished height (catchup_replay) needs the consensus state machine and
its WAL, which are not ported yet (ROADMAP 1.5).

Reference parity: consensus/replay.go (Handshaker:200, Handshake:241,
ReplayBlocks:285, replayBlock:472, mockProxyApp:516).
"""

from __future__ import annotations

from ..abci import types as abci
from ..libs.log import get_logger
from ..state.state import State as SMState
from ..version import BLOCK_PROTOCOL, P2P_PROTOCOL, SOFTWARE_VERSION

log = get_logger("consensus-replay")


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
