"""Replay console: step a consensus state through a recorded WAL (the
port's copy of tendermint_tpu/consensus/replay_file.py).

Reference parity: consensus/replay_file.go (RunReplayFile — `tendermint
replay` / `replay_console`).  Rebuilds the node's stores + a fresh
ConsensusState in replay mode, then feeds the WAL records for the last
unfinished height through the same _replay_record path crash recovery
uses.  Console mode pauses for operator input between records (`n` steps,
a number steps that many, `q` quits, empty line = 1)."""

from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.kvstore import open_db
from ..libs.log import get_logger
from ..proxy import AppConns, default_client_creator
from ..state import StateStore
from ..state.execution import BlockExecutor
from ..store import BlockStore
from ..types.genesis import GenesisDoc
from ..types.events import EventBus
from .replay import Handshaker, _replay_record
from .state import ConsensusState
from .wal import WAL


async def run_replay_file(config, console: bool = False, input_fn=input) -> int:
    """Returns the number of WAL records replayed."""
    log = get_logger("replay-console")
    genesis_doc = GenesisDoc.from_file(config.genesis_file())
    genesis_doc.validate_and_complete()
    home = None if config.base.db_backend == "memdb" else config.home
    block_store = BlockStore(open_db("blockstore", home, config.base.db_backend))
    state_store = StateStore(open_db("state", home, config.base.db_backend))
    state = state_store.load_from_db_or_genesis(genesis_doc)

    event_bus = EventBus()
    await event_bus.start()
    proxy_app = AppConns(default_client_creator(config.base.proxy_app, config.base.abci))
    await proxy_app.start()
    try:
        handshaker = Handshaker(state_store, state, block_store, genesis_doc)
        state = await handshaker.handshake(proxy_app)

        from ..mempool import NopMempool

        block_exec = BlockExecutor(
            state_store, proxy_app.consensus(), NopMempool(), event_bus=event_bus
        )
        cs = ConsensusState(
            config.consensus, state, block_exec, block_store, NopMempool(),
            event_bus=event_bus,
        )
        cs.replay_mode = True

        wal = WAL(config.wal_file())
        records, found = wal.search_for_end_height(state.last_block_height)
        if not found or records is None:
            log.info("no WAL records past stored height", height=state.last_block_height)
            return 0

        cs.rs.height = state.last_block_height + 1
        replayed = 0
        budget = 0
        for rec in records:
            if console and budget == 0:
                cmd = input_fn(f"[{replayed}] step> ").strip()
                if cmd == "q":
                    break
                budget = int(cmd) if cmd.isdigit() else 1
            budget = max(0, budget - 1)
            await _replay_record(cs, rec)
            replayed += 1
        log.info("replay done", records=replayed, height=cs.rs.height)
        return replayed
    finally:
        await proxy_app.stop()
        await event_bus.stop()
