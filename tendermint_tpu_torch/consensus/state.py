"""The consensus state machine (the port's copy of
tendermint_tpu/consensus/state.py).

Reference parity: consensus/state.go (State:75, receiveRoutine:602,
handleMsg:678, handleTimeout:745, enterNewRound:815, enterPropose:895,
defaultDecideProposal:968, enterPrevote:1063, enterPrevoteWait:1113,
enterPrecommit:1158, enterPrecommitWait:1262, enterCommit:1288,
tryFinalizeCommit:1352, finalizeCommit:1381, defaultSetProposal:1600,
addProposalBlockPart:1636, tryAddVote:1706, addVote:1751, signVote:1922,
signAddVote:1961, updateToState:505, reconstructLastCommit:487).

Architecture: all mutation is serialized through ONE asyncio task reading a
single queue (the reference's single-goroutine receiveRoutine — its core
race-avoidance mechanism, SURVEY.md §5).  Timeouts are forwarded from the
ticker into the same queue; every input is WAL-logged before processing
(fsync for our own signed messages) so crash replay is deterministic.

The `decide_proposal` / `do_prevote` / `set_proposal` methods are instance
attributes precisely so byzantine tests can hijack them
(consensus/state.go:124-126).

Aggregate (BLS) commits: on a uniformly BLS12-381 set with `[consensus]
bls_aggregate_commits` on, `_maybe_fold_commit` folds every +2/3 commit
(the proposal's last commit and the seen commit) into an AggregateCommit;
a peer two heights ahead ships that stored commit in an `agg_commit` frame,
which `_apply_aggregate_commit` checks with one pairing before the height
finalizes from it.
"""

from __future__ import annotations

import asyncio
import errno
import time
from typing import Optional, Tuple

from ..libs.fail import fail_point
from ..libs.log import get_logger
from ..libs.service import Service
from ..state.state import State as SMState
from ..types.agg_commit import AggregateCommit, AggregateLastCommit, fold_commit
from ..types.block import Block, BlockID, Commit, PartSetHeader
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.part_set import Part, PartSet, PartSetError
from ..types.params import BLOCK_PART_SIZE_BYTES
from ..types.proposal import Proposal
from ..types.validator import NotEnoughVotingPowerError
from ..types.vote import ErrVoteConflictingVotes, Vote, VoteError
from ..types.vote_set import VoteSet
from .ticker import TimeoutInfo, TimeoutTicker
from .types import GotVoteFromUnwantedRoundError, HeightVoteSet, RoundState, RoundStep
from .wal import NilWAL


class VoteHeightMismatchError(VoteError):
    pass


class InvalidProposalSignatureError(Exception):
    pass


class InvalidProposalPOLRoundError(Exception):
    pass


#: OSError errnos that genuinely mean "the disk refused" — the storage-halt
#: and refuse-the-sign paths trigger ONLY on these; every other OSError
#: (connection resets from a socket ABCI app or remote signer, interrupted
#: syscalls, ...) keeps its original handling
_STORAGE_ERRNOS = frozenset(
    getattr(errno, name)
    for name in ("ENOSPC", "EDQUOT", "EIO", "EROFS", "ENODEV", "ENXIO", "EFBIG")
    if hasattr(errno, name)
)


def _is_storage_fault(e: BaseException) -> bool:
    return (
        isinstance(e, OSError)
        and not isinstance(e, ConnectionError)
        and e.errno in _STORAGE_ERRNOS
    )


async def _maybe_await(x):
    """PrivValidator impls may be sync (FilePV/MockPV) or async (the remote
    SignerClient, privval/signer_client.go) — tolerate both."""
    import inspect

    if inspect.isawaitable(x):
        return await x
    return x


class ConsensusState(Service):
    def __init__(
        self,
        config,  # ConsensusConfig
        state: SMState,
        block_exec,
        block_store,
        mempool,
        evidence_pool=None,
        event_bus=None,
        options=None,
    ):
        super().__init__("consensus")
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.log = get_logger("consensus")

        self.priv_validator = None
        self.wal = NilWAL()
        self.do_wal_catchup = True
        #: set when the receive routine halted CLEANLY on a storage fault
        #: (ENOSPC/EIO from the WAL, block store or state store) — the
        #: node's read path stays up, only consensus participation stops
        self.halted_reason: Optional[str] = None
        #: node wires a libs.watchdog.StorageHealth so persistence faults
        #: reach the disk_fault watchdog alarm + forensics pipeline
        self.storage_health = None
        # set only while finalizing from a peer-shipped AggregateCommit;
        # update_to_state consumes it as the next height's last-commit
        self._pending_agg_last_commit = None
        # -- consensus pipeline (config.pipeline_delivery) -----------------
        # In-flight ABCI delivery for the last committed height: a task
        # resolving to ("ok", (new_state, retain_height)) or ("err", exc)
        # — it never raises, so a dropped consume can't warn.  While it is
        # set, sm_state is the PROVISIONAL next state (identical validator
        # rotation, app_hash/results hash unknown); every reader of
        # delivery output goes through _ensure_delivered() first, which
        # joins the task and swaps the delivered state in.
        self._delivery_task: Optional[asyncio.Task] = None
        self._delivery_height = 0
        # speculative proposal stash built on the delivery lane:
        # (height, mempool_version, commit_sig_count, block, parts)
        self._spec_proposal: Optional[tuple] = None
        self.replay_mode = False
        from ..libs import tracing
        from ..libs.metrics import ConsensusMetrics

        self.metrics = ConsensusMetrics()  # nop; node swaps in prometheus
        self.recorder = tracing.NOP  # node swaps in its FlightRecorder
        self._total_txs = 0
        # Pluggable time source (chaos/clock.py): every wall-clock and
        # monotonic read in the state machine goes through this object, so
        # fault injection can skew ONE node's clock ([chaos] clock_skew /
        # unsafe_chaos_clock_skew) without touching the process or peers.
        from ..chaos.clock import SYSTEM_CLOCK

        self.clock = SYSTEM_CLOCK

        # the round state
        self.rs = RoundState()
        self.sm_state: Optional[SMState] = None

        self.timeout_ticker = TimeoutTicker()
        self.msg_queue: asyncio.Queue = asyncio.Queue(maxsize=1000)
        self.n_steps = 0
        self._receive_task: Optional[asyncio.Task] = None
        self._ticker_pump: Optional[asyncio.Task] = None
        self._txs_pump: Optional[asyncio.Task] = None
        self._done = asyncio.Event()

        # observers (reactor hooks; the reference's evsw synchronous events)
        self.on_new_round_step = []  # callables(RoundState)
        self.on_vote = []  # callables(Vote)
        self.on_valid_block = []  # callables(RoundState)
        self.on_proposal_heartbeat = []
        # gossip wakeup hooks: the reactor's event-driven gossip routines
        # wait on these instead of polling every peer_gossip_sleep tick
        self.on_proposal = []  # callables(RoundState) — a proposal landed
        self.on_new_block_part = []  # callables(RoundState) — a part landed

        # overridable behaviours for byzantine tests
        self.decide_proposal = self.default_decide_proposal
        self.do_prevote = self.default_do_prevote
        self.set_proposal = self.default_set_proposal

        self.update_to_state(state)
        self.reconstruct_last_commit_if_needed(state)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def set_priv_validator(self, pv) -> None:
        self.priv_validator = pv

    def reconstruct_last_commit_if_needed(self, state: SMState) -> None:
        """consensus/state.go:487 — rebuild LastCommit votes from the
        stored SeenCommit, one host verify per signature.  An aggregate
        seen commit has no per-vote signatures to rebuild a VoteSet from:
        verify its single pairing against the stored set and carry it
        through an adapter instead (proposal assembly embeds it as it is;
        height-1 straggler precommits are ignored, the commit is +2/3)."""
        if state.last_block_height == 0:
            return
        seen_commit = self.block_store.load_seen_commit(state.last_block_height)
        if seen_commit is None:
            raise RuntimeError(
                f"failed to reconstruct last commit: seen commit for height "
                f"{state.last_block_height} not found"
            )
        if isinstance(seen_commit, AggregateCommit):
            state.last_validators.verify_commit(
                state.chain_id, seen_commit.block_id, state.last_block_height, seen_commit
            )
            self.rs.last_commit = AggregateLastCommit(seen_commit)
            return
        last_precommits = commit_to_vote_set(state.chain_id, seen_commit, state.last_validators)
        if not last_precommits.has_two_thirds_majority():
            raise RuntimeError("failed to reconstruct last commit: does not have +2/3 maj")
        self.rs.last_commit = last_precommits

    async def on_start(self) -> None:
        await self.timeout_ticker.start()
        if self.do_wal_catchup and not isinstance(self.wal, NilWAL):
            from ..consensus.wal import WALCorruptionError
            from .replay import catchup_replay

            try:
                await catchup_replay(self, self.rs.height)
            except WALCorruptionError:
                self.log.error("corrupt WAL file; repair it before restarting")
                raise
            except Exception as e:
                # state.go:328 — e.g. a crash between save_block and the
                # ENDHEIGHT marker leaves the WAL one marker short; the
                # handshake already replayed the block, so proceed.
                self.log.error("error on catchup replay; proceeding to start anyway", err=repr(e))
        self._ticker_pump = self.spawn(self._pump_timeouts(), "ticker-pump")
        if self.mempool.txs_available() is not None:
            self._txs_pump = self.spawn(self._pump_txs_available(), "txs-pump")
        self._receive_task = self.spawn(self._receive_routine(), "receive")
        self.schedule_round0()

    async def on_stop(self) -> None:
        # Quiesce the receive/pump tasks BEFORE stopping the ticker and
        # closing the WAL: a message processed after either would schedule
        # a fresh timer on a dead ticker (leaked task) or write to a closed
        # WAL file.  Service.stop's generic cancel pass happens after
        # on_stop, which is too late for that ordering.
        for t in (self._receive_task, self._ticker_pump, self._txs_pump):
            if t is not None and not t.done():
                t.cancel()
                # asyncio.wait, not wait_for: a task that survives its
                # cancel (e.g. 3.10 wait_for swallowing it mid-sign,
                # bpo-42130) must not strangle node teardown — after the
                # grace window, proceed; Service.stop's cancel pass covers
                # the stragglers
                await asyncio.wait({t}, timeout=2.0)
        # Drain the pipelined delivery, not cancel it: the lane is
        # mid-ABCI-commit holding the mempool lock and writing the state
        # store — let it land so a restart finds store/state consistent
        # (a crash here is exactly the handshake's store==state+1 lane).
        if self._delivery_task is not None:
            task = self._delivery_task
            try:
                await asyncio.wait_for(self._ensure_delivered(), timeout=5.0)
            except asyncio.CancelledError:
                if not task.cancelled():
                    raise  # on_stop itself is being cancelled from outside
                # The lane died cancelled anyway: store_height ==
                # state_height + 1, the handshake's replay case — log and
                # keep tearing down rather than abort node shutdown.
                self.log.error("pipelined delivery cancelled during shutdown")
            except Exception as e:
                self.log.error("pipelined delivery failed during shutdown", err=repr(e))
        await self.timeout_ticker.stop()
        # A straggler receive task past the grace window may still be
        # mid-message; closing the WAL under it would lose the tail it is
        # writing.  Its own finally closes the WAL when it unwinds.
        if self._receive_task is None or self._receive_task.done():
            self.wal.close()

    async def wait_done(self) -> None:
        await self._done.wait()

    # ------------------------------------------------------------------
    # inputs (reactor/public surface)
    # ------------------------------------------------------------------
    async def add_vote_input(self, vote: Vote, peer_id: str = "", verified: bool = False) -> None:
        """verified=True marks a signature already checked by the reactor's
        batch-verification path (SURVEY.md §7 inversion #1) — structural
        validation still happens in the VoteSet."""
        await self.msg_queue.put(
            {"type": "vote", "vote": vote, "peer_id": peer_id, "verified": verified}
        )

    async def set_proposal_input(self, proposal: Proposal, peer_id: str = "") -> None:
        await self.msg_queue.put({"type": "proposal", "proposal": proposal, "peer_id": peer_id})

    async def add_agg_commit_input(self, commit, peer_id: str = "") -> None:
        """Catchup fast path for aggregate-commit nets: a peer two or more
        heights ahead has no per-vote precommits to serve for a folded
        height, so it ships the stored AggregateCommit itself (the
        reactor's `agg_commit` frame); ONE pairing replaces the vote tally."""
        await self.msg_queue.put({"type": "agg_commit", "commit": commit, "peer_id": peer_id})

    async def add_block_part_input(
        self, height: int, round_: int, part: Part, peer_id: str = ""
    ) -> None:
        await self.msg_queue.put(
            {"type": "block_part", "height": height, "round": round_, "part": part, "peer_id": peer_id}
        )

    async def set_proposal_and_block(
        self, proposal: Proposal, block_parts: PartSet, peer_id: str = ""
    ) -> None:
        await self.set_proposal_input(proposal, peer_id)
        for i in range(block_parts.total):
            await self.add_block_part_input(proposal.height, proposal.round, block_parts.get_part(i), peer_id)

    def _send_internal_nowait(self, mi: dict) -> None:
        """sendInternalMessage (state.go:477): never drop our own msgs."""
        try:
            self.msg_queue.put_nowait(mi)
        except asyncio.QueueFull:
            asyncio.get_event_loop().create_task(self.msg_queue.put(mi))

    # ------------------------------------------------------------------
    # the serialized receive loop
    # ------------------------------------------------------------------
    async def _pump_timeouts(self) -> None:
        while True:
            ti = await self.timeout_ticker.chan().get()
            await self.msg_queue.put({"type": "timeout", "ti": ti})

    async def _pump_txs_available(self) -> None:
        while True:
            ev = self.mempool.txs_available()
            await ev.wait()
            ev.clear()
            await self.msg_queue.put({"type": "txs_available"})

    # messages drained per scheduling turn: one explicit yield per BATCH,
    # not per message.  A yield per message puts this routine at the BACK
    # of the ready queue each time — on a busy loop (a committee-scale
    # in-proc net runs ~15k tasks) per-message latency becomes a full
    # ready-queue drain and the queue grows without bound (measured: ~5
    # msgs/sec drain at N=100 while votes arrived faster).  With a shallow
    # queue the batch is 1 and behavior is identical to the reference's.
    RECV_BATCH = 64

    async def _receive_routine(self) -> None:
        """state.go:602 — the single serialization point."""
        try:
            while True:
                # Queue.get returns without yielding when non-empty; the loop
                # is self-feeding (own votes/parts), so yield explicitly or
                # every other task on the loop starves.
                await asyncio.sleep(0)
                batch = [await self.msg_queue.get()]
                while len(batch) < self.RECV_BATCH:
                    try:
                        batch.append(self.msg_queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                for mi in batch:
                    kind = mi["type"]
                    if kind == "timeout":
                        ti: TimeoutInfo = mi["ti"]
                        self.wal.write(
                            {"type": "timeout", "height": ti.height, "round": ti.round,
                             "step": ti.step, "duration": ti.duration}
                        )
                        await self._handle_timeout(ti)
                    elif kind == "txs_available":
                        await self._handle_txs_available()
                    else:
                        internal = not mi.get("peer_id")
                        wal_rec = {"type": "msg", "peer_id": mi.get("peer_id", ""), "msg": _wire_msg(mi)}
                        if internal:
                            self.wal.write_sync(wal_rec)  # own msgs fsync (state.go:650)
                            if kind == "vote":
                                fail_point("own-vote-walled")
                        else:
                            self.wal.write(wal_rec)
                        await self._handle_msg(mi)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # chain halt on consensus failure (state.go:617)
            if _is_storage_fault(e):
                # storage fault (ENOSPC / EIO from the WAL, block store or
                # state store): a node that cannot PERSIST must not keep
                # signing — but this is a CLEAN, attributed halt, not an
                # undefined-state CONSENSUS FAILURE.  Nothing was signed
                # past the failed write (the WAL append precedes
                # processing, the privval save precedes signature
                # release), the RPC read path stays up, and the watchdog's
                # disk_fault alarm + forensics pipeline get the event.
                # ONLY storage errnos qualify — a ConnectionResetError
                # from a socket ABCI app is an OSError too, and routing it
                # here would hand the operator disk forensics for an
                # app-layer failure.
                self._storage_halt(e)
            else:
                import traceback

                self.log.error("CONSENSUS FAILURE!!!", err=repr(e))
                traceback.print_exc()
        finally:
            try:
                self.wal.close()
            except OSError:
                pass  # a dying disk may refuse even the close flush
            self._done.set()

    def _storage_halt(self, err: OSError) -> None:
        kind = errno.errorcode.get(err.errno, "OSError") if err.errno else "OSError"
        self.halted_reason = f"storage fault ({kind}): {err}"
        self.log.error(
            "consensus halted on storage fault (clean)",
            err=repr(err),
            height=self.rs.height,
            round=self.rs.round,
        )
        self.recorder.record(
            "consensus.storage_halt", fault=kind, height=self.rs.height
        )
        sh = self.storage_health
        if sh is not None:
            sh.note_write_error("consensus", err)
            sh.note_halt("consensus", self.halted_reason)

    async def _handle_msg(self, mi: dict) -> None:
        """state.go:678."""
        kind, peer_id = mi["type"], mi.get("peer_id", "")
        try:
            if kind == "proposal":
                had = self.rs.proposal is not None
                await self.set_proposal(mi["proposal"])
                if not had and self.rs.proposal is not None:
                    # provenance: who BORN this proposal onto this node —
                    # "self" is the proposer itself; a peer id prefix marks
                    # a relay hop.  tracemerge keys "proposal born" on the
                    # src="self" event across the merged dumps.
                    p = self.rs.proposal
                    self.recorder.record(
                        "proposal", height=p.height, round=p.round,
                        src=peer_id[:8] if peer_id else "self",
                    )
                    for cb in self.on_proposal:
                        cb(self.rs)
            elif kind == "block_part":
                added = await self._add_proposal_block_part(
                    mi["height"], mi["round"], mi["part"], peer_id
                )
                if added:
                    for cb in self.on_new_block_part:
                        cb(self.rs)
            elif kind == "vote":
                await self._try_add_vote(mi["vote"], peer_id, mi.get("verified", False))
            elif kind == "agg_commit":
                await self._apply_aggregate_commit(mi["commit"], peer_id)
        except ErrVoteConflictingVotes:
            raise  # own double-sign — _try_add_vote re-raises only then; halt
        except (VoteError, PartSetError, InvalidProposalSignatureError,
                InvalidProposalPOLRoundError, GotVoteFromUnwantedRoundError) as e:
            # peer errors: log and keep the receive loop alive — a byzantine
            # peer must not be able to halt consensus (reactor.go:222 treats
            # these as peer misbehaviour, not consensus failure)
            self.log.debug("error with msg", kind=kind, peer=peer_id, err=str(e))

    async def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """state.go:745 — timeouts must match current H/R/S."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (
            ti.round == rs.round and ti.step < rs.step
        ):
            return
        if ti.step == RoundStep.NEW_HEIGHT:
            await self.enter_new_round(ti.height, 0)
        elif ti.step == RoundStep.NEW_ROUND:
            await self.enter_propose(ti.height, 0)
        elif ti.step == RoundStep.PROPOSE:
            if self.event_bus:
                await self.event_bus.publish_timeout_propose(rs.event_dict())
            await self.enter_prevote(ti.height, ti.round)
        elif ti.step == RoundStep.PREVOTE_WAIT:
            if self.event_bus:
                await self.event_bus.publish_timeout_wait(rs.event_dict())
            await self.enter_precommit(ti.height, ti.round)
        elif ti.step == RoundStep.PRECOMMIT_WAIT:
            if self.event_bus:
                await self.event_bus.publish_timeout_wait(rs.event_dict())
            await self.enter_precommit(ti.height, ti.round)
            await self.enter_new_round(ti.height, ti.round + 1)
        else:
            raise ValueError(f"invalid timeout step {ti.step}")

    async def _handle_txs_available(self) -> None:
        """state.go:787."""
        if self.rs.round != 0:
            return
        if self.rs.step == RoundStep.NEW_HEIGHT:
            if self._need_proof_block(self.rs.height):
                return
            timeout_commit = self.rs.start_time - self.clock.monotonic() + 0.001
            self._schedule_timeout(timeout_commit, self.rs.height, 0, RoundStep.NEW_ROUND)
        elif self.rs.step == RoundStep.NEW_ROUND:
            await self.enter_propose(self.rs.height, 0)

    # ------------------------------------------------------------------
    # state transitions
    # ------------------------------------------------------------------
    async def enter_new_round(self, height: int, round_: int) -> None:
        """state.go:815."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != RoundStep.NEW_HEIGHT
        ):
            return
        self.log.debug("enterNewRound", height=height, round=round_)

        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)

        self._update_round_step(round_, RoundStep.NEW_ROUND)
        rs.validators = validators
        if round_ != 0:
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # track next round for skipping
        rs.triggered_timeout_precommit = False

        if self.event_bus:
            await self.event_bus.publish_new_round(height, round_, validators.get_proposer())

        wait_for_txs = (
            self.config.wait_for_txs() and round_ == 0 and not self._need_proof_block(height)
        )
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval, height, round_, RoundStep.NEW_ROUND
                )
        else:
            await self.enter_propose(height, round_)

    def _need_proof_block(self, height: int) -> bool:
        """state.go:877 — first height, or app hash changed last block."""
        if height == 1:
            return True
        if self._delivery_task is not None:
            # pipelined delivery in flight: the last app hash is not known
            # yet — assume it changed (propose immediately rather than
            # stall the pipeline waiting for txs)
            return True
        last_meta = self.block_store.load_block_meta(height - 1)
        if last_meta is None:
            raise RuntimeError(f"need_proof_block: no block meta for height {height - 1}")
        return self.sm_state.app_hash != last_meta.header.app_hash

    async def enter_propose(self, height: int, round_: int) -> None:
        """state.go:895."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PROPOSE
        ):
            return
        self.log.debug("enterPropose", height=height, round=round_)

        try:
            self._schedule_timeout(self.config.propose(round_), height, round_, RoundStep.PROPOSE)
            if self.priv_validator is None:
                return
            address = self.priv_validator.get_pub_key().address()
            if not rs.validators.has_address(address):
                return
            if self._is_proposer(address):
                self.log.info("our turn to propose", height=height, round=round_)
                await self.decide_proposal(height, round_)
        finally:
            self._update_round_step(round_, RoundStep.PROPOSE)
            await self._new_step()
            if self._is_proposal_complete():
                await self.enter_prevote(height, self.rs.round)

    def _is_proposer(self, address: bytes) -> bool:
        return self.rs.validators.get_proposer().address == address

    async def default_decide_proposal(self, height: int, round_: int) -> None:
        """state.go:968."""
        # the header we are about to build embeds the previous height's
        # app_hash and results hash — join the pipelined delivery first
        await self._ensure_delivered()
        rs = self.rs
        if rs.height != height or rs.round != round_:
            return  # the state machine moved on while we awaited delivery
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            created = self._create_proposal_block()
            if created is None:
                return
            block, block_parts = created

        # flush WAL so replay recomputes the same proposal (state.go:986)
        self.wal.flush_and_sync()

        prop_block_id = BlockID(block.hash(), block_parts.header())
        proposal = Proposal(
            height=height,
            round=round_,
            pol_round=rs.valid_round,
            block_id=prop_block_id,
            timestamp_ns=self.clock.time_ns(),
        )
        try:
            await _maybe_await(self.priv_validator.sign_proposal(self.sm_state.chain_id, proposal))
        except Exception as e:
            if not self.replay_mode:
                self.log.error("error signing proposal", height=height, round=round_, err=str(e))
            return
        self._send_internal_nowait({"type": "proposal", "proposal": proposal, "peer_id": ""})
        for i in range(block_parts.total):
            self._send_internal_nowait(
                {
                    "type": "block_part",
                    "height": rs.height,
                    "round": rs.round,
                    "part": block_parts.get_part(i),
                    "peer_id": "",
                }
            )
        self.log.info("signed proposal", height=height, round=round_)

    def _create_proposal_block(self) -> Optional[Tuple[Block, PartSet]]:
        """state.go:1021."""
        rs = self.rs
        spec, self._spec_proposal = self._spec_proposal, None
        if (
            spec is not None
            and spec[0] == rs.height
            and spec[1] == getattr(self.mempool, "version", None)
            and spec[2] == self._last_commit_signed_count()
        ):
            # speculative assembly: the block pre-built on the delivery
            # lane is still valid — same height, untouched mempool (the
            # reap would return the same set), same last-commit signers
            self.recorder.record("proposal.speculative_hit", height=rs.height)
            return spec[3], spec[4]
        if rs.height == 1:
            commit = Commit(0, 0, BlockID(), [])
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            commit = self._maybe_fold_commit(
                rs.last_commit.make_commit(), self.sm_state.last_validators
            )
        else:
            self.log.error("cannot propose: no commit for the previous block")
            return None
        proposer_addr = self.priv_validator.get_pub_key().address()
        block = self.block_exec.create_proposal_block(
            rs.height, self.sm_state, commit, proposer_addr
        )
        parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
        return block, parts

    def _maybe_fold_commit(self, commit, val_set):
        """Fold a +2/3 commit into ONE aggregate BLS signature and a signer
        bitmap when the signing set is uniformly BLS (types/agg_commit.py).
        A commit that cannot fold (a mixed or non-BLS set, or one already
        folded by the restart adapter) passes unchanged: aggregation turns
        itself off, and per-scheme routing still verifies it."""
        if not getattr(self.config, "bls_aggregate_commits", True):
            return commit
        folded = fold_commit(commit, val_set, self.sm_state.chain_id)
        if folded is None:
            return commit
        self.recorder.record(
            "commit.aggregate",
            height=folded.height,
            signers=folded.signers.count(),
            bytes=len(folded.encode()),
        )
        return folded

    def _last_commit_signed_count(self) -> int:
        """Signer count of rs.last_commit — the speculative-proposal
        invalidation key for the embedded commit: votes are only ever
        ADDED, so an equal count means the identical signer set."""
        lc = self.rs.last_commit
        if lc is None:
            return -1
        try:
            return lc.bit_array().count()
        except Exception:
            return -1

    def _is_proposal_complete(self) -> bool:
        """state.go:1000."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    async def enter_prevote(self, height: int, round_: int) -> None:
        """state.go:1063."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE
        ):
            return
        self.log.debug("enterPrevote", height=height, round=round_)
        try:
            await self.do_prevote(height, round_)
        finally:
            self._update_round_step(round_, RoundStep.PREVOTE)
            await self._new_step()

    async def default_do_prevote(self, height: int, round_: int) -> None:
        """state.go:1093."""
        # validate_block below compares the header's app_hash /
        # results hash / params against sm_state — join the pipelined
        # delivery so those fields are the committed ones
        await self._ensure_delivered()
        rs = self.rs
        if rs.locked_block is not None:
            await self._sign_add_vote(PREVOTE_TYPE, rs.locked_block.hash(), rs.locked_block_parts.header())
            return
        if rs.proposal_block is None:
            await self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.sm_state, rs.proposal_block)
        except Exception as e:
            self.log.error("prevote: ProposalBlock is invalid", err=str(e))
            await self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return
        # Timestamp sanity (reference state/validation.go block-time area,
        # extended node-side): a proposal whose header time is beyond local
        # now + drift would commit a block every light client rejects —
        # refuse it here, at prevote, before it can gather a polka.
        drift_ns = int(self.config.proposal_clock_drift * 1e9)
        if drift_ns > 0 and rs.proposal_block.time_ns > self.clock.time_ns() + drift_ns:
            self.log.error(
                "prevote: ProposalBlock time too far in the future",
                block_time_ns=rs.proposal_block.time_ns,
                drift_s=self.config.proposal_clock_drift,
            )
            await self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return
        await self._sign_add_vote(
            PREVOTE_TYPE, rs.proposal_block.hash(), rs.proposal_block_parts.header()
        )

    async def enter_prevote_wait(self, height: int, round_: int) -> None:
        """state.go:1113."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE_WAIT
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise RuntimeError(f"enterPrevoteWait({height}/{round_}) without +2/3 prevotes")
        self._update_round_step(round_, RoundStep.PREVOTE_WAIT)
        await self._new_step()
        self._schedule_timeout(self.config.prevote(round_), height, round_, RoundStep.PREVOTE_WAIT)

    async def enter_precommit(self, height: int, round_: int) -> None:
        """state.go:1158."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PRECOMMIT
        ):
            return
        self.log.debug("enterPrecommit", height=height, round=round_)

        # the lock path validates the proposal block against sm_state;
        # normally a no-op (do_prevote already joined), but a node pulled
        # straight to precommit by peer +2/3 must not validate against the
        # provisional state
        await self._ensure_delivered()

        try:
            prevotes = rs.votes.prevotes(round_)
            block_id, ok = (prevotes.two_thirds_majority() if prevotes else (None, False))

            if not ok:
                # no polka: precommit nil
                await self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
                return

            if self.event_bus:
                await self.event_bus.publish_polka(rs.event_dict())

            pol_round, _ = rs.votes.pol_info()
            if pol_round < round_:
                raise RuntimeError(f"POLRound should be {round_} but got {pol_round}")

            if block_id.is_zero():
                # +2/3 prevoted nil: unlock
                if rs.locked_block is not None:
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                    if self.event_bus:
                        await self.event_bus.publish_unlock(rs.event_dict())
                await self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
                return

            if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
                # relock
                rs.locked_round = round_
                if self.event_bus:
                    await self.event_bus.publish_relock(rs.event_dict())
                await self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash, block_id.parts_header)
                return

            if rs.proposal_block is not None and rs.proposal_block.hashes_to(block_id.hash):
                # lock
                self.block_exec.validate_block(self.sm_state, rs.proposal_block)
                rs.locked_round = round_
                rs.locked_block = rs.proposal_block
                rs.locked_block_parts = rs.proposal_block_parts
                if self.event_bus:
                    await self.event_bus.publish_lock(rs.event_dict())
                await self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash, block_id.parts_header)
                return

            # polka for a block we don't have: unlock, fetch, precommit nil
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                block_id.parts_header
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet.from_header(block_id.parts_header)
            if self.event_bus:
                await self.event_bus.publish_unlock(rs.event_dict())
            await self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
        finally:
            self._update_round_step(round_, RoundStep.PRECOMMIT)
            await self._new_step()

    async def enter_precommit_wait(self, height: int, round_: int) -> None:
        """state.go:1262."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise RuntimeError(f"enterPrecommitWait({height}/{round_}) without +2/3 precommits")
        rs.triggered_timeout_precommit = True
        await self._new_step()
        self._schedule_timeout(
            self.config.precommit(round_), height, round_, RoundStep.PRECOMMIT_WAIT
        )

    async def enter_commit(self, height: int, commit_round: int) -> None:
        """state.go:1288."""
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        self.log.debug("enterCommit", height=height, commit_round=commit_round)
        try:
            block_id, ok = rs.votes.precommits(commit_round).two_thirds_majority()
            if not ok:
                raise RuntimeError("enterCommit expects +2/3 precommits")

            if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
                rs.proposal_block = rs.locked_block
                rs.proposal_block_parts = rs.locked_block_parts

            if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
                if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                    block_id.parts_header
                ):
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet.from_header(block_id.parts_header)
                    if self.event_bus:
                        await self.event_bus.publish_valid_block(rs.event_dict())
                    for cb in self.on_valid_block:
                        cb(rs)
        finally:
            self._update_round_step(rs.round, RoundStep.COMMIT)
            rs.commit_round = commit_round
            rs.commit_time = self.clock.monotonic()
            await self._new_step()
            await self.try_finalize_commit(height)

    async def try_finalize_commit(self, height: int) -> None:
        """state.go:1352."""
        rs = self.rs
        if rs.height != height:
            raise RuntimeError(f"try_finalize_commit: height mismatch {rs.height} vs {height}")
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, ok = precommits.two_thirds_majority()
        if not ok or block_id.is_zero():
            return
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
            return
        await self.finalize_commit(height)

    async def finalize_commit(self, height: int) -> None:
        """state.go:1381 — save block, WAL end-height, ApplyBlock, advance."""
        rs = self.rs
        if rs.height != height or rs.step != RoundStep.COMMIT:
            return
        block_id, ok = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        if not ok:
            raise RuntimeError("cannot finalize commit: no +2/3 majority")
        await self._finalize_block(
            block_id,
            lambda: self._maybe_fold_commit(
                rs.votes.precommits(rs.commit_round).make_commit(), rs.validators
            ),
        )

    async def _apply_aggregate_commit(self, commit, peer_id: str = "") -> None:
        """Commit this height from a peer-shipped AggregateCommit: the
        catchup lane for folded heights (their per-vote precommits exist
        nowhere, so the vote tally can never fire).  One pairing against
        OUR validator set authenticates it; the block is either in hand, or
        the part set is retargeted so catchup block parts flow, with the
        verified commit parked on rs.catchup_agg_commit for the
        completion hook."""
        rs = self.rs
        if commit.height != rs.height or rs.validators is None:
            return
        if self.block_store.height() >= commit.height:
            return  # already committed; duplicate catchup frame
        try:
            commit.validate_basic()
            # one pairing + a +2/3-power tally, memoized in the scheme so a
            # resent frame costs a dict lookup
            rs.validators.verify_commit(
                self.sm_state.chain_id, commit.block_id, commit.height, commit
            )
        except (ValueError, NotEnoughVotingPowerError) as e:
            # NotEnoughVotingPowerError is not a ValueError: a peer that
            # aggregates a genuine minority of signers (a valid pairing
            # under 2/3 of the power) is dropped here, not passed to the
            # receive loop as a consensus failure
            self.log.debug("invalid agg_commit from peer", peer=peer_id, err=str(e))
            return
        self.recorder.record(
            "commit.agg_catchup", height=commit.height,
            src=peer_id[:8] if peer_id else "self",
        )
        if rs.locked_block is not None and rs.locked_block.hashes_to(commit.block_id.hash):
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is not None and rs.proposal_block.hashes_to(commit.block_id.hash):
            await self._finalize_from_aggregate(commit)
            return
        # block not in hand: retarget the part set (enter_commit's
        # unknown-block shape) and let the data-gossip catchup fill it
        rs.catchup_agg_commit = commit
        if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
            commit.block_id.parts_header
        ):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet.from_header(commit.block_id.parts_header)
            if self.event_bus:
                await self.event_bus.publish_valid_block(rs.event_dict())
            for cb in self.on_valid_block:
                cb(rs)

    async def _finalize_from_aggregate(self, commit) -> None:
        rs = self.rs
        rs.catchup_agg_commit = None
        rs.commit_round = max(commit.round, 0)
        self._update_round_step(rs.round, RoundStep.COMMIT)
        rs.commit_time = self.clock.monotonic()
        await self._new_step()
        # update_to_state (inside _finalize_block) must not look for +2/3
        # in the precommit vote set: the commit's votes never existed here;
        # carry the verified aggregate as the next height's last-commit
        # adapter instead
        self._pending_agg_last_commit = AggregateLastCommit(commit)
        try:
            await self._finalize_block(commit.block_id, lambda: commit)
        finally:
            self._pending_agg_last_commit = None

    async def _finalize_block(self, block_id, seen_commit_fn) -> None:
        """The source-independent tail of finalize_commit: `block_id` and
        the lazily-built seen commit come from either the precommit vote
        set (the normal path) or a verified AggregateCommit (catchup)."""
        # one delivery in flight at a time: H's apply must complete (and
        # its state swap in) before H+1's persist/apply can start
        await self._ensure_delivered()
        rs = self.rs
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if not block_parts.has_header(block_id.parts_header):
            raise RuntimeError("commit parts header mismatch")
        if not block.hashes_to(block_id.hash):
            raise RuntimeError("cannot finalize commit: proposal block does not hash to commit hash")
        self.block_exec.validate_block(self.sm_state, block)

        self.log.info(
            "finalizing commit of block",
            height=block.height,
            hash=block.hash().hex()[:16],
            txs=len(block.txs),
        )
        fail_point("finalize-pre-save")

        if self.block_store.height() < block.height:
            self.block_store.save_block(block, block_parts, seen_commit_fn())
        fail_point("finalize-saved-block")
        self.recorder.record(
            "commit", height=block.height, txs=len(block.txs),
            block=block.hash().hex()[:12],
        )
        self._record_metrics(block)

        # end-height marker implies the block store has the block (wal.go:46)
        self.wal.write_end_height(block.height)
        fail_point("finalize-walled-endheight")

        state_copy = self.sm_state.copy()
        bid = BlockID(block.hash(), block_parts.header())
        self.recorder.record("deliver.start", height=block.height)

        if not self.config.pipeline_delivery or self.replay_mode:
            # serial path (A/B off switch + WAL replay): the reference's
            # strictly sequential finalize
            new_state, retain_height = await self.block_exec.apply_block(
                state_copy, bid, block
            )
            self.recorder.record("deliver.end", height=block.height)
            fail_point("finalize-applied")
            self._prune_if_requested(retain_height)
            self.update_to_state(new_state)
            self.schedule_round0()
            return

        # pipelined path: H is durable (block + seen commit saved, WAL
        # ENDHEIGHT written) — ship ABCI delivery onto its own lane and
        # advance the round machinery to H+1 under the provisional state.
        # A crash before the lane lands leaves store_height ==
        # state_height + 1, exactly the handshake's existing replay case.
        from ..state.execution import provisional_next_state

        provisional = provisional_next_state(state_copy, bid, block)
        self._delivery_height = block.height
        self._delivery_task = self.spawn(
            self._deliver_block(state_copy, bid, block), "deliver"
        )
        self.update_to_state(provisional)
        self.schedule_round0()

    async def _deliver_block(self, state_copy, block_id, block) -> tuple:
        """The pipelined delivery lane: apply_block (begin/deliver_tx/
        end/commit + state save + event publication) off the receive
        routine.  Resolves to a ("ok"|"err", payload) pair instead of
        raising so an unconsumed task never logs a phantom crash; the
        _ensure_delivered() awaiter re-raises errors into the receive
        routine where the storage-fault classifier lives."""
        try:
            new_state, retain_height = await self.block_exec.apply_block(
                state_copy, block_id, block
            )
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            return ("err", e)
        self.recorder.record("deliver.end", height=block.height)
        fail_point("finalize-applied")
        if self.config.pipeline_speculative_assembly:
            self._speculate_proposal(new_state)
        return ("ok", (new_state, retain_height))

    async def _ensure_delivered(self) -> None:
        """Join the in-flight pipelined delivery, if any.  Every reader
        of delivery output — the proposer embedding the committed
        app_hash into the next header, prevote/precommit validation, the
        next finalize — calls this first.  Swaps the provisional state
        for the delivered one: the validator rotation is identical by
        construction (provisional_next_state), delivery fills in
        app_hash, last_results_hash and the validator/param updates."""
        task = self._delivery_task
        if task is None:
            return
        # shield: when an awaiter parked here is cancelled (on_stop
        # cancelling the receive routine), asyncio cancels the awaiter's
        # _fut_waiter — which without the shield IS the delivery task.
        # The lane may be mid-ABCI-commit; the canceller's unwind must
        # not kill it.  The awaiter still sees CancelledError and
        # unwinds; the lane keeps running for the shutdown drain.
        status, payload = await asyncio.shield(task)
        if self._delivery_task is not task:
            return  # a concurrent awaiter (shutdown drain) consumed it
        self._delivery_task = None
        if status == "err":
            self._spec_proposal = None
            raise payload
        new_state, retain_height = payload
        self.sm_state = new_state
        self._prune_if_requested(retain_height)

    def _speculate_proposal(self, state) -> None:
        """Speculative block assembly (runs on the delivery lane, after
        apply): if this node proposes the next height's round 0, pre-reap
        the mempool and pre-build the block + part set now, while the
        net is still exchanging votes.  _create_proposal_block consumes
        the stash only if the reap inputs are provably unchanged
        (mempool version + last-commit signer count)."""
        try:
            rs = self.rs
            if (
                self.priv_validator is None
                or rs.height != state.last_block_height + 1
                or rs.round != 0
                or rs.proposal is not None
                or rs.last_commit is None
                or not rs.last_commit.has_two_thirds_majority()
            ):
                return
            addr = self.priv_validator.get_pub_key().address()
            if rs.validators.get_proposer().address != addr:
                return
            commit = self._maybe_fold_commit(
                rs.last_commit.make_commit(), state.last_validators
            )
            block = self.block_exec.create_proposal_block(rs.height, state, commit, addr)
            parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
            self._spec_proposal = (
                rs.height,
                getattr(self.mempool, "version", None),
                self._last_commit_signed_count(),
                block,
                parts,
            )
            self.recorder.record(
                "proposal.speculative", height=rs.height, txs=len(block.txs)
            )
        except Exception as e:  # speculation must never break delivery
            self._spec_proposal = None
            self.log.debug("speculative assembly failed", err=str(e))

    def _prune_if_requested(self, retain_height: int) -> None:
        if retain_height <= 0:
            return
        try:
            base = self.block_store.base()
            if retain_height > base:
                pruned = self.block_store.prune_blocks(retain_height)
                self.state_prune(retain_height)
                self.log.info("pruned blocks", pruned=pruned, retain_height=retain_height)
        except Exception as e:
            self.log.error("failed to prune blocks", err=str(e))

    def state_prune(self, retain_height: int) -> None:
        self.block_exec.state_store.prune_states(retain_height)

    def _record_metrics(self, block) -> None:
        """consensus/state.go:1458 recordMetrics."""
        m = self.metrics
        rs = self.rs
        try:
            m.height.set(block.height)
            vals = rs.validators
            m.validators.set(vals.size())
            m.validators_power.set(vals.total_voting_power())
            pre = rs.votes.precommits(rs.commit_round)
            missing = missing_power = 0
            for i, v in enumerate(vals.validators):
                if pre.get_by_index(i) is None:
                    missing += 1
                    missing_power += v.voting_power
            m.missing_validators.set(missing)
            m.missing_validators_power.set(missing_power)
            byz = byz_power = 0
            for ev in getattr(block, "evidence", []) or []:
                byz += 1
                addr = getattr(ev, "address", None)
                if callable(addr):  # Evidence.address() is a method
                    addr = addr()
                if isinstance(addr, bytes):
                    _, v = vals.get_by_address(addr)
                    if v is not None:
                        byz_power += v.voting_power
            m.byzantine_validators.set(byz)
            m.byzantine_validators_power.set(byz_power)
            m.rounds.set(rs.round)
            m.num_txs.set(len(block.txs))
            self._total_txs += len(block.txs)
            m.total_txs.set(self._total_txs)
            m.block_size_bytes.set(sum(len(tx) for tx in block.txs))
            m.committed_height.set(block.height)
            prev = self.block_store.load_block_meta(block.height - 1)
            if prev is not None:
                m.block_interval_seconds.observe(
                    max(0.0, (block.header.time_ns - prev.header.time_ns) / 1e9)
                )
        except Exception as e:  # metrics must never break consensus
            self.log.error("record metrics failed", err=repr(e))

    # ------------------------------------------------------------------
    # proposal + block parts
    # ------------------------------------------------------------------
    async def default_set_proposal(self, proposal: Proposal) -> None:
        """state.go:1600."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (
            0 <= proposal.pol_round and proposal.pol_round >= proposal.round
        ):
            raise InvalidProposalPOLRoundError("invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify(
            proposal.sign_bytes(self.sm_state.chain_id), proposal.signature
        ):
            raise InvalidProposalSignatureError("invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet.from_header(proposal.block_id.parts_header)
        self.log.info("received proposal", height=proposal.height, round=proposal.round)

    async def _add_proposal_block_part(
        self, height: int, round_: int, part: Part, peer_id: str
    ) -> bool:
        """state.go:1636."""
        rs = self.rs
        if rs.height != height:
            return False
        if rs.proposal_block_parts is None:
            return False
        try:
            added = rs.proposal_block_parts.add_part(part)
        except PartSetError:
            if round_ != rs.round:
                return False  # wrong-round part, not necessarily malicious
            raise
        if added and rs.proposal_block_parts.is_complete():
            try:
                block = Block.deserialize(rs.proposal_block_parts.assemble())
            except Exception as e:
                # A maliciously assembled part set decodes to garbage: reset
                # so honest parts can rebuild, and surface a peer error
                # instead of killing the receive loop (state.go:1655 returns
                # err; reactor treats it as peer misbehaviour).
                rs.proposal_block_parts = (
                    PartSet.from_header(rs.proposal.block_id.parts_header)
                    if rs.proposal is not None
                    else None
                )
                raise PartSetError(f"proposal block does not decode: {e!r}") from e
            rs.proposal_block = block
            # cross-node timeline: when THIS node first held the whole
            # proposal — the per-node part-coverage point tracemerge
            # aggregates into coverage p50/p90 across the net
            self.recorder.record(
                "block.parts_complete",
                height=rs.height, round=round_,
                parts=rs.proposal_block_parts.total,
                src=peer_id[:8] if peer_id else "self",
            )
            self.log.info(
                "received complete proposal block",
                height=rs.proposal_block.height,
                hash=rs.proposal_block.hash().hex()[:16],
            )
            if self.event_bus:
                await self.event_bus.publish_complete_proposal(rs.event_dict())

            prevotes = rs.votes.prevotes(rs.round)
            block_id, has_two_thirds = (
                prevotes.two_thirds_majority() if prevotes else (None, False)
            )
            if has_two_thirds and not block_id.is_zero() and rs.valid_round < rs.round:
                if rs.proposal_block.hashes_to(block_id.hash):
                    rs.valid_round = rs.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts

            agg = rs.catchup_agg_commit
            if (
                agg is not None
                and agg.height == rs.height
                and rs.proposal_block.hashes_to(agg.block_id.hash)
            ):
                # aggregate-commit catchup: the commit was verified before
                # the block arrived; finalize now that the block is whole
                await self._finalize_from_aggregate(agg)
                return added

            if rs.step <= RoundStep.PROPOSE and self._is_proposal_complete():
                await self.enter_prevote(height, rs.round)
                if has_two_thirds:
                    await self.enter_precommit(height, rs.round)
            elif rs.step == RoundStep.COMMIT:
                await self.try_finalize_commit(height)
        return added

    # ------------------------------------------------------------------
    # votes
    # ------------------------------------------------------------------
    async def _try_add_vote(self, vote: Vote, peer_id: str, verified: bool = False) -> bool:
        """state.go:1706."""
        try:
            return await self._add_vote(vote, peer_id, verified)
        except VoteHeightMismatchError:
            return False
        except ErrVoteConflictingVotes as e:
            if self.priv_validator is not None and (
                vote.validator_address == self.priv_validator.get_pub_key().address()
            ):
                self.log.error(
                    "found conflicting vote from ourselves; did you unsafe-reset a validator?",
                    height=vote.height,
                    round=vote.round,
                )
                raise
            if self.evidence_pool is not None and e.evidence is not None:
                self.evidence_pool.add_evidence(e.evidence)
            return False

    async def _add_vote(self, vote: Vote, peer_id: str, verified: bool = False) -> bool:
        """state.go:1751."""
        rs = self.rs

        # precommit straggler for the previous height during NEW_HEIGHT
        if vote.height + 1 == rs.height:
            if not (rs.step == RoundStep.NEW_HEIGHT and vote.type == PRECOMMIT_TYPE):
                raise VoteHeightMismatchError("wrong height, not a LastCommit straggler")
            if rs.last_commit is None:
                raise VoteHeightMismatchError("no last commit to add straggler vote to")
            added = rs.last_commit.add_vote(vote, verify=not verified)
            if not added:
                return False
            self.log.debug("added to lastPrecommits")
            await self._publish_vote(vote)
            if self.config.skip_timeout_commit and rs.last_commit.has_all():
                await self.enter_new_round(rs.height, 0)
            return True

        if vote.height != rs.height:
            raise VoteHeightMismatchError(f"vote height {vote.height} != {rs.height}")

        height = rs.height
        added = rs.votes.add_vote(vote, peer_id, verify=not verified)
        if not added:
            return False
        await self._publish_vote(vote)

        if vote.type == PREVOTE_TYPE:
            prevotes = rs.votes.prevotes(vote.round)
            block_id, ok = prevotes.two_thirds_majority()
            if ok:
                # unlock on newer polka (state.go:1832)
                if (
                    rs.locked_block is not None
                    and rs.locked_round < vote.round <= rs.round
                    and not rs.locked_block.hashes_to(block_id.hash)
                ):
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                    if self.event_bus:
                        await self.event_bus.publish_unlock(rs.event_dict())
                # update valid block (state.go:1849)
                if (
                    not block_id.is_zero()
                    and rs.valid_round < vote.round
                    and vote.round == rs.round
                ):
                    if rs.proposal_block is not None and rs.proposal_block.hashes_to(block_id.hash):
                        rs.valid_round = vote.round
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
                    else:
                        rs.proposal_block = None
                    if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                        block_id.parts_header
                    ):
                        rs.proposal_block_parts = PartSet.from_header(block_id.parts_header)
                    for cb in self.on_valid_block:
                        cb(rs)
                    if self.event_bus:
                        await self.event_bus.publish_valid_block(rs.event_dict())

            if rs.round < vote.round and prevotes.has_two_thirds_any():
                await self.enter_new_round(height, vote.round)  # round skip
            elif rs.round == vote.round and rs.step >= RoundStep.PREVOTE:
                block_id, ok = prevotes.two_thirds_majority()
                if ok and (self._is_proposal_complete() or block_id.is_zero()):
                    await self.enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    await self.enter_prevote_wait(height, vote.round)
            elif rs.proposal is not None and 0 <= rs.proposal.pol_round == vote.round:
                if self._is_proposal_complete():
                    await self.enter_prevote(height, rs.round)

        elif vote.type == PRECOMMIT_TYPE:
            precommits = rs.votes.precommits(vote.round)
            block_id, ok = precommits.two_thirds_majority()
            if ok:
                await self.enter_new_round(height, vote.round)
                await self.enter_precommit(height, vote.round)
                if not block_id.is_zero():
                    await self.enter_commit(height, vote.round)
                    if self.config.skip_timeout_commit and precommits.has_all():
                        await self.enter_new_round(self.rs.height, 0)
                else:
                    await self.enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                await self.enter_new_round(height, vote.round)
                await self.enter_precommit_wait(height, vote.round)
        else:
            raise ValueError(f"unexpected vote type {vote.type}")
        return True

    async def _publish_vote(self, vote: Vote) -> None:
        if self.event_bus:
            await self.event_bus.publish_vote(vote)
        for cb in self.on_vote:
            cb(vote)

    # -- signing -----------------------------------------------------------
    async def _sign_vote(self, msg_type: int, hash_: bytes, header: PartSetHeader) -> Vote:
        """state.go:1922."""
        self.wal.flush_and_sync()
        pub_key = self.priv_validator.get_pub_key()
        addr = pub_key.address()
        val_idx, _ = self.rs.validators.get_by_address(addr)
        vote = Vote(
            type=msg_type,
            height=self.rs.height,
            round=self.rs.round,
            block_id=BlockID(hash_, header),
            timestamp_ns=self._vote_time(),
            validator_address=addr,
            validator_index=val_idx,
        )
        await _maybe_await(self.priv_validator.sign_vote(self.sm_state.chain_id, vote))
        return vote

    def _vote_time(self) -> int:
        """BFT-time monotonicity (state.go:1952)."""
        now = self.clock.time_ns()
        min_time = now
        iota_ns = self.sm_state.consensus_params.block.time_iota_ms * 1_000_000
        if self.rs.locked_block is not None:
            min_time = self.rs.locked_block.time_ns + iota_ns
        elif self.rs.proposal_block is not None:
            min_time = self.rs.proposal_block.time_ns + iota_ns
        return max(now, min_time)

    async def _sign_add_vote(self, msg_type: int, hash_: bytes, header: PartSetHeader) -> Optional[Vote]:
        """state.go:1961."""
        if self.priv_validator is None:
            return None
        pub_key = self.priv_validator.get_pub_key()
        if not self.rs.validators.has_address(pub_key.address()):
            return None
        try:
            vote = await self._sign_vote(msg_type, hash_, header)
        except Exception as e:
            if _is_storage_fault(e):
                # the sign path REFUSED: either the pre-sign WAL fsync or
                # the privval's last-sign-state save failed (ENOSPC/EIO).
                # No signature escaped — persist-before-release means not
                # voting is the SAFE degradation.  Record it so the
                # watchdog's disk_fault alarm fires, but keep consensus
                # alive (the disk may heal; peers' votes still advance
                # us).  A remote-signer connection error stays on the
                # generic path below — that is not disk forensics.
                self.log.error(
                    "vote refused: sign-path persistence failure", err=repr(e)
                )
                sh = self.storage_health
                if sh is not None:
                    sh.note_write_error("sign", e)
            elif not self.replay_mode:
                self.log.error("error signing vote", err=str(e))
            return None
        self._send_internal_nowait({"type": "vote", "vote": vote, "peer_id": ""})
        self.log.debug("signed and pushed vote", height=self.rs.height, round=self.rs.round)
        return vote

    # ------------------------------------------------------------------
    # height housekeeping
    # ------------------------------------------------------------------
    def update_to_state(self, state: SMState) -> None:
        """state.go:505."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height != state.last_block_height:
            raise RuntimeError(
                f"update_to_state expected height {rs.height}, got {state.last_block_height}"
            )
        if (
            self.sm_state is not None
            and not self.sm_state.is_empty()
            and self.sm_state.last_block_height + 1 != rs.height
        ):
            raise RuntimeError("inconsistent sm_state height vs rs height")

        if (
            self.sm_state is not None
            and not self.sm_state.is_empty()
            and state.last_block_height <= self.sm_state.last_block_height
        ):
            # SwitchToConsensus with stale state — just re-signal
            return

        last_precommits = None
        pending_agg = self._pending_agg_last_commit
        if pending_agg is not None and pending_agg.height == state.last_block_height:
            # aggregate-commit catchup: the committed height's precommits
            # never existed as votes here; the verified aggregate itself is
            # the last-commit surface (the restart's adapter)
            last_precommits = pending_agg
        elif rs.commit_round > -1 and rs.votes is not None:
            pc = rs.votes.precommits(rs.commit_round)
            if pc is None or not pc.has_two_thirds_majority():
                raise RuntimeError("update_to_state called but last precommit round lacks +2/3")
            last_precommits = pc
        elif rs.last_commit is not None and rs.last_commit.height == state.last_block_height:
            # keep a LastCommit reconstructed from the seen commit (fast-sync
            # handover path) instead of clobbering it
            last_precommits = rs.last_commit

        height = state.last_block_height + 1
        rs.height = height
        self._update_round_step(0, RoundStep.NEW_HEIGHT)
        now = self.clock.monotonic()
        base = rs.commit_time if rs.commit_time else now
        rs.start_time = self.config.commit(base)
        rs.validators = state.validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, state.validators)
        rs.commit_round = -1
        rs.last_commit = last_precommits
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self.sm_state = state
        # live consensus-key migration: a multi-key privval (RotatingPV)
        # selects whichever of its keys is a member of THIS height's set —
        # notified here, at the exact height boundary where an ABCI-driven
        # key rotation becomes effective, so the node never signs with a
        # key the set no longer contains (or doesn't contain yet)
        pv = self.priv_validator
        if pv is not None and hasattr(pv, "observe_validators"):
            try:
                pv.observe_validators(state.validators)
            except Exception as e:
                self.log.error("privval observe_validators failed", err=repr(e))

    def _update_round_step(self, round_: int, step: int) -> None:
        self.rs.round = round_
        self.rs.step = step
        self.recorder.record(
            "step", height=self.rs.height, round=round_, step=RoundStep.NAMES[step]
        )

    async def _new_step(self) -> None:
        """state.go:590 newStep: WAL the round state + notify."""
        self.wal.write({"type": "roundstate", **self.rs.event_dict()})
        self.n_steps += 1
        if self.event_bus:
            await self.event_bus.publish_new_round_step(self.rs.event_dict())
        for cb in self.on_new_round_step:
            cb(self.rs)

    def schedule_round0(self) -> None:
        """state.go:466 — enter_new_round(height, 0) at start_time."""
        sleep = self.rs.start_time - self.clock.monotonic()
        lc = self.rs.last_commit
        if (
            self.config.skip_timeout_commit
            and self.config.commit_grace > 0
            and sleep > self.config.commit_grace
            and lc is not None
            and not lc.has_all()
        ):
            # all-precommits grace: skip_timeout_commit only fires on
            # has_all() (state.go:1598) — one slow or dead validator would
            # forfeit the skip forever and every height would eat the full
            # timeout_commit.  With +2/3 already in hand, wait at most
            # commit_grace for the stragglers; the has_all short-circuits
            # in _add_vote still fire the instant the last one lands.
            sleep = self.config.commit_grace
        self._schedule_timeout(sleep, self.rs.height, 0, RoundStep.NEW_HEIGHT)

    def _schedule_timeout(self, duration: float, height: int, round_: int, step: int) -> None:
        self.timeout_ticker.schedule_timeout(TimeoutInfo(duration, height, round_, step))

    # -- introspection (RPC dump_consensus_state) --------------------------
    def get_round_state(self) -> RoundState:
        return self.rs

    def load_commit(self, height: int) -> Optional[Commit]:
        if height == self.block_store.height():
            return self.block_store.load_seen_commit(height)
        return self.block_store.load_block_commit(height)


def commit_to_vote_set(chain_id: str, commit: Commit, vals) -> VoteSet:
    """types/block.go:586 CommitToVoteSet."""
    vote_set = VoteSet(chain_id, commit.height, commit.round, PRECOMMIT_TYPE, vals)
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        added = vote_set.add_vote(commit.get_vote(idx))
        if not added:
            raise RuntimeError("failed to reconstruct LastCommit")
    return vote_set


def _wire_msg(mi: dict) -> dict:
    """WAL-serializable form of a consensus message."""
    kind = mi["type"]
    if kind == "vote":
        return {"type": "vote", "vote": mi["vote"].to_dict()}
    if kind == "proposal":
        return {"type": "proposal", "proposal": mi["proposal"].to_dict()}
    if kind == "block_part":
        return {
            "type": "block_part",
            "height": mi["height"],
            "round": mi["round"],
            "part": mi["part"].to_dict(),
        }
    return {"type": kind}
