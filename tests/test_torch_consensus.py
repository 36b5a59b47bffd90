"""The port's consensus core (tendermint_tpu_torch: consensus/state.py with
its types, ticker, WAL and catchup replay, privval/file.py, Proposal)
against the JAX package's, on a 4-validator chain.

`run_chain(first, after)` drives one node the way node.py wires it: MemDB
stores, the kvstore app behind AppConns(local_client_creator(app)), the
Handshaker, a Mempool with the signed-tx precheck (host path), an
EvidencePool, an EventBus, a BlockExecutor and a ConsensusState with a
FilePV, a WAL and a MockTicker that fires only when the test says so.  The
test plays the other 3 validators: the round's proposer builds its block
with the node's BlockExecutor from the node's LastCommit and hands over the
signed Proposal and its parts (cut at 256 bytes); the peers' prevotes and
precommits arrive as one frame each, verified first (the port through its
AsyncBatchVerifier on device="cpu", the JAX package on the host), then
added with verified=True, as the consensus reactor adds a vote_batch.
Height 1 and 2 are proposed by peers, and at 2 a peer also sends a
conflicting prevote (evidence in the pool); height 3 is ours (the FilePV
signs it, the evidence in it); at 4 the round-0 proposer withholds its
proposal (nil prevotes and precommits, round 1 commits); height 5 is
plain; in height 6 the node stops after its own precommit and a new
ConsensusState (of `after`, on the stores, WAL and privval files left by
`first`) recovers through catchup_replay before the peers' precommits
commit it.  Every clock read is a fixed clock.  ed25519 signing is
deterministic, so all four runs (port, JAX, JAX then port, port then JAX)
give the same bytes: blocks, app hashes, states, events, the WAL records
without their wall-clock time_ns, and the FilePV state.  Tolerance: exact.
"""

import asyncio
import contextlib
import dataclasses
import os
import tempfile
import time
import types

import pytest
import torch

import tendermint_tpu.abci.examples as jexamples
import tendermint_tpu.chaos.clock as jclock
import tendermint_tpu.config as jconfig
import tendermint_tpu.consensus.replay as jreplay
import tendermint_tpu.consensus.state as jstate_machine
import tendermint_tpu.consensus.ticker as jticker
import tendermint_tpu.consensus.wal as jwal
import tendermint_tpu.evidence as jevpool
import tendermint_tpu.libs.kvstore as jkvstore
import tendermint_tpu.mempool as jmempool
import tendermint_tpu.privval.file as jfile
import tendermint_tpu.proxy as jproxy
import tendermint_tpu.state as jstate
import tendermint_tpu.state.execution as jexecution
import tendermint_tpu.types as jtypes
import tendermint_tpu.types.events as jevents
import tendermint_tpu.types.genesis as jgenesis
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.store import BlockStore as JBlockStore
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch import evidence as pevpool
from tendermint_tpu_torch import mempool as pmempool
from tendermint_tpu_torch import proxy as pproxy
from tendermint_tpu_torch import state as pstate
from tendermint_tpu_torch.abci import examples as pexamples
from tendermint_tpu_torch.chaos import clock as pclock
from tendermint_tpu_torch.consensus import replay as preplay
from tendermint_tpu_torch.consensus import state as pstate_machine
from tendermint_tpu_torch.consensus import ticker as pticker
from tendermint_tpu_torch.consensus import types as pcstypes
from tendermint_tpu_torch.consensus import wal as pwal
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs import kvstore as pkvstore
from tendermint_tpu_torch.privval import file as pfile
from tendermint_tpu_torch.state import execution as pexecution
from tendermint_tpu_torch.store import BlockStore as PBlockStore
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import events as pevents
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import proposal as pproposal
from tendermint_tpu_torch.types import vote as pvote

torch.set_num_threads(1)

PORT = types.SimpleNamespace(
    name="port", PrivKey=Ed25519PrivKey, clock=pclock, config=pconfig, replay=preplay,
    machine=pstate_machine, ticker=pticker, wal=pwal, evpool=pevpool,
    kvstore=pkvstore, mempool=pmempool, file=pfile, proxy=pproxy, state=pstate,
    execution=pexecution, events=pevents, genesis=pgenesis, examples=pexamples,
    BlockStore=PBlockStore, BlockID=pblock.BlockID, Commit=pblock.Commit,
    Proposal=pproposal.Proposal, Vote=pvote.Vote)
JAX = types.SimpleNamespace(
    name="jax", PrivKey=JPrivKey, clock=jclock, config=jconfig, replay=jreplay,
    machine=jstate_machine, ticker=jticker, wal=jwal, evpool=jevpool,
    kvstore=jkvstore, mempool=jmempool, file=jfile, proxy=jproxy, state=jstate,
    execution=jexecution, events=jevents, genesis=jgenesis, examples=jexamples,
    BlockStore=JBlockStore, BlockID=jtypes.BlockID, Commit=jtypes.Commit,
    Proposal=jtypes.Proposal, Vote=jtypes.Vote)

CHAIN = "cs-parity"
SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC
NOW_NS = T0 + 5 * SEC  # the fixed clock's wall time ...
NOW_MONO = 1000.0  # ... and its monotonic time
N_VALS, HEIGHTS = 4, 6
OURS_AT = 3  # our validator proposes this height
CONFLICT_AT = 2  # a peer sends two prevotes here
WITHHELD_AT = 4  # the round-0 proposer withholds its proposal
CRASH_AT = 6  # the node stops after its own precommit and recovers
PART = 256
DBS = ("state", "blockstore", "app", "evidence")
STEP = pcstypes.RoundStep


class FixedClock:
    def time_ns(self) -> int:
        return NOW_NS

    def monotonic(self) -> float:
        return NOW_MONO


@contextlib.contextmanager
def fixed_clock(ns):
    """ConsensusState reads SYSTEM_CLOCK at construction (its update_to_state
    already reads the clock)."""
    real = ns.clock.SYSTEM_CLOCK
    ns.clock.SYSTEM_CLOCK = FixedClock()
    try:
        yield
    finally:
        ns.clock.SYSTEM_CLOCK = real


def chain_keys(ns):
    return [ns.PrivKey.from_secret(f"cs-{i}".encode()) for i in range(N_VALS)]


def genesis(ns, keys):
    gen = ns.genesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        ns.genesis.GenesisValidator(k.pub_key().address(), k.pub_key(), 10, f"v{i}")
        for i, k in enumerate(keys)])
    gen.validate_and_complete()
    return gen


def our_key(ns, keys, gen):
    """The validator the genesis set's rotation makes round-0 proposer of
    OURS_AT."""
    vals = ns.state.make_genesis_state(gen).validators.copy()
    vals.increment_proposer_priority(OURS_AT - 1)
    addr = vals.get_proposer().address
    return next(k for k in keys if k.pub_key().address() == addr)


def view(x):
    """A package-neutral picture of a value (event data, responses)."""
    if hasattr(x, "to_dict"):
        return view(x.to_dict())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return view(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: view(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [view(v) for v in x]
    return x


def without_time(records):
    return [{k: v for k, v in r.items() if k != "time_ns"} for r in records]


async def until(node, cond, what, timeout=120.0):
    """Yield to the loop until cond() holds; fail if consensus died."""
    deadline = time.monotonic() + timeout
    while not cond():
        if node.cs._done.is_set():
            raise AssertionError(f"consensus stopped while waiting for {what}")
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what} at {node.cs.rs.height}/"
                                 f"{node.cs.rs.round}/{node.cs.rs.step}")
        await asyncio.sleep(0)


class Node:
    """One package's node on MemDB stores seeded from `items` (a dump of
    another node's stores, or nothing), its WAL and FilePV under `home`."""

    def __init__(self, ns, home, keys, gen, ours, items=None):
        self.ns, self.home, self.keys, self.gen, self.ours = ns, home, keys, gen, ours
        self.items = items or {}
        self.events = []

    async def open(self):
        ns = self.ns
        self.dbs = {}
        for name in DBS:
            self.dbs[name] = ns.kvstore.MemDB()
            self.dbs[name].write_batch(self.items.get(name, []))
        self.state_store = ns.state.StateStore(self.dbs["state"])
        self.block_store = ns.BlockStore(self.dbs["blockstore"])
        self.app = ns.examples.KVStoreApplication(db=self.dbs["app"])
        self.conns = ns.proxy.AppConns(ns.proxy.local_client_creator(self.app))
        self.bus = ns.events.EventBus()
        await self.conns.start()
        await self.bus.start()
        self.sub = await self.bus.subscribe("rig", "tm.event EXISTS", 1 << 20)
        state = self.state_store.load_from_db_or_genesis(self.gen)
        self.handshaker = ns.replay.Handshaker(self.state_store, state, self.block_store, self.gen)
        state = await self.handshaker.handshake(self.conns)
        self.mempool = ns.mempool.Mempool(self.conns.mempool(), {"sig_precheck": True},
                                          height=state.last_block_height)
        self.mempool.pre_check = ns.execution.tx_pre_check(state)
        self.evpool = ns.evpool.EvidencePool(self.dbs["evidence"], self.state_store, state)
        self.executor = ns.execution.BlockExecutor(self.state_store, self.conns.consensus(),
                                                   self.mempool, self.evpool, self.bus)
        if ns is PORT:
            self.verifier = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device="cpu",
                                                                     min_device_batch=2))
            await self.verifier.start()
        with fixed_clock(ns):
            self.cs = ns.machine.ConsensusState(ns.config.ConsensusConfig(), state, self.executor,
                                                self.block_store, self.mempool, self.evpool,
                                                self.bus)
        self.ticker = ns.ticker.MockTicker()
        self.ticker.fire_on_schedule = set()  # every timeout waits for the test
        self.cs.timeout_ticker = self.ticker
        self.pv = ns.file.FilePV.load(os.path.join(self.home, "priv_validator_key.json"),
                                      os.path.join(self.home, "priv_validator_state.json"))
        self.cs.set_priv_validator(self.pv)
        self.cs.wal = ns.wal.WAL(os.path.join(self.home, "cs.wal", "wal"))
        await self.cs.start()
        return self

    async def close(self):
        """Stop consensus (drains the pipelined delivery), keep the events
        and return the stores' items."""
        await self.cs.stop()
        self.drain()
        if self.ns is PORT:
            await self.verifier.stop()
        await self.bus.stop()
        await self.conns.stop()
        return {name: list(db.iterate_prefix(b"")) for name, db in self.dbs.items()}

    def drain(self):
        while not self.sub.queue.empty():
            msg = self.sub.queue.get_nowait()
            self.events.append((msg.data.type, view(msg.data.data), view(msg.events)))

    async def verify(self, votes):
        """A frame's verdicts: the port's engine lane, or the JAX host path."""
        vals = self.cs.rs.validators
        items = [(vals.get_by_address(v.validator_address)[1].pub_key, v.sign_bytes(CHAIN),
                  v.signature) for v in votes]
        if self.ns is PORT:
            return await self.verifier.verify_direct([(pk.bytes(), m, s) for pk, m, s in items])
        return [pk.verify(m, s) for pk, m, s in items]


def fire(node, h, r, step):
    """Fire the timeout the node scheduled for (h, r, step)."""
    ti = [t for t in node.ticker.scheduled if (t.height, t.round, t.step) == (h, r, step)][-1]
    node.ticker.fire(ti)


async def delivered(node):
    task = node.cs._delivery_task
    if task is not None:
        await asyncio.wait({task})


def at(node, h, r, step):
    rs = node.cs.rs
    return (rs.height, rs.round, rs.step) >= (h, r, step)


def own_vote(node, kind, r):
    vs = (node.cs.rs.votes.prevotes if kind == 1 else node.cs.rs.votes.precommits)(r)
    return vs is not None and vs.get_by_address(node.ours.pub_key().address()) is not None


def peer_votes(node, kind, h, r, block, block_id):
    """The other validators' votes for block (or nil), stamped as
    _vote_time stamps them."""
    ns, out = node.ns, []
    iota = node.cs.sm_state.consensus_params.block.time_iota_ms * 1_000_000
    ts = max(NOW_NS, block.time_ns + iota) if block is not None else NOW_NS
    for key in node.keys:
        if key is node.ours:
            continue
        idx, _ = node.cs.rs.validators.get_by_address(key.pub_key().address())
        v = ns.Vote(kind, h, r, block_id, ts, key.pub_key().address(), idx)
        v.signature = key.sign(v.sign_bytes(CHAIN))
        out.append(v)
    return out


async def send(node, votes, peer="peer-0"):
    ok = await node.verify(votes)
    assert all(ok), ok
    for v in votes:
        await node.cs.add_vote_input(v, peer, verified=True)


async def propose(node, h, r, key):
    """A peer's proposal: its block from the node's executor and LastCommit."""
    ns = node.ns
    await delivered(node)
    state = node.state_store.load()
    commit = (ns.Commit(0, 0, ns.BlockID(), []) if h == 1
              else node.cs.rs.last_commit.make_commit())
    block = node.executor.create_proposal_block(h, state, commit, key.pub_key().address())
    parts = block.make_part_set(PART)
    prop = ns.Proposal(height=h, round=r, pol_round=-1,
                       block_id=ns.BlockID(block.hash(), parts.header()), timestamp_ns=NOW_NS)
    prop.signature = key.sign(prop.sign_bytes(CHAIN))
    await node.cs.set_proposal_and_block(prop, parts, f"peer-{key.pub_key().address().hex()[:4]}")


async def submit_txs(node, h):
    """A few kv txs and signed envelopes, the second envelope corrupted."""
    ns = node.ns
    out = []
    txs = [b"k%d-%d=v" % (h, i) for i in range(2)]
    for i in range(3):
        tx = ns.mempool.make_signed_tx(node.keys[i], b"s%d-%d=v" % (h, i))
        if i == 1:
            off = len(ns.mempool.SIGNED_TX_PREFIX) + 32
            tx = tx[:off] + bytes([tx[off] ^ 1]) + tx[off + 1:]
        txs.append(tx)
    for tx in txs:
        try:
            res = await node.mempool.check_tx(tx)
            out.append(("ok", res.code))
        except Exception as e:  # noqa: BLE001 - the parity is over any rejection
            out.append((type(e).__name__, str(e)))
    return out


async def play_round(node, h, r):
    """Round r of height h from the node's PROPOSE on; returns whether the
    height committed."""
    cs = node.cs
    await until(node, lambda: at(node, h, r, STEP.PROPOSE), f"propose {h}/{r}")
    proposer = cs.rs.validators.get_proposer()
    key = next(k for k in node.keys if k.pub_key().address() == proposer.address)
    if key is node.ours:
        pass  # default_decide_proposal signs and sends it
    elif h == WITHHELD_AT and r == 0:
        fire(node, h, r, STEP.PROPOSE)
    else:
        await propose(node, h, r, key)
    await until(node, lambda: at(node, h, r, STEP.PREVOTE) and own_vote(node, 1, r),
                f"our prevote {h}/{r}")
    block = cs.rs.proposal_block
    bid = (node.ns.BlockID(block.hash(), cs.rs.proposal_block_parts.header())
           if block is not None else node.ns.BlockID())
    prevotes = peer_votes(node, 1, h, r, block, bid)
    await send(node, prevotes)
    await until(node, lambda: at(node, h, r, STEP.PRECOMMIT) and own_vote(node, 2, r),
                f"our precommit {h}/{r}")
    if h == CONFLICT_AT:
        nil = peer_votes(node, 1, h, r, None, node.ns.BlockID())[:1]
        await send(node, nil, "peer-1")
        await until(node, lambda: node.evpool.num_pending() == 1, "the evidence")
    if h == CRASH_AT:
        return False
    await send(node, peer_votes(node, 2, h, r, block, bid))
    if block is None:
        await until(node, lambda: cs.rs.triggered_timeout_precommit, f"precommit wait {h}/{r}")
        fire(node, h, r, STEP.PRECOMMIT_WAIT)
        return False
    await until(node, lambda: cs.rs.height == h + 1 and cs.rs.last_commit.has_all(),
                f"commit {h}")
    return True


def snapshot(node, h):
    """What height h left behind, once its delivery landed."""
    block = node.block_store.load_block(h)
    node.drain()
    events, node.events = node.events, []
    return {
        "block": block.hash(),
        "round": node.block_store.load_seen_commit(h).round,
        "proposer": block.header.proposer_address,
        "last_commit": block.last_commit.size() if h > 1 else 0,
        "evidence": [ev.hash() for ev in block.evidence],
        "txs": list(block.txs),
        "app_hash": node.app.app_hash,
        "state": node.state_store.load().to_dict(),
        "events": events,
        "wal": without_time(node.cs.wal.all_records()),
        "privval": open(node.pv.last_sign_state.file_path).read(),
        "pending_evidence": node.evpool.num_pending(),
    }


async def run_chain(first, after=None):
    """Heights 1 .. HEIGHTS (see the module docstring); `after` runs the
    node from the restart in CRASH_AT on."""
    after = after or first
    home = tempfile.mkdtemp(prefix="cs-parity-")
    keys = chain_keys(first)
    gen = genesis(first, keys)
    ours = our_key(first, keys, gen)
    pv_key = first.file.FilePVKey(ours.pub_key().address(), ours.pub_key(), ours,
                                  os.path.join(home, "priv_validator_key.json"))
    first.file.FilePV(pv_key, first.file.FilePVLastSignState(
        file_path=os.path.join(home, "priv_validator_state.json"))).save()
    out = {"checks": {}, "heights": {}}
    node = await Node(first, home, keys, gen, ours).open()
    try:
        for h in range(1, HEIGHTS + 1):
            await until(node, lambda: at(node, h, 0, STEP.NEW_HEIGHT), f"new height {h}")
            await delivered(node)
            out["checks"][h] = await submit_txs(node, h)
            fire(node, h, 0, STEP.NEW_HEIGHT)
            r = 0
            while not await play_round(node, h, r):
                if h == CRASH_AT and node.cs.rs.height == h and node.ns is first:
                    items = await node.close()
                    signed = node.cs.rs.votes.precommits(0).get_by_address(
                        ours.pub_key().address())
                    events = node.events
                    node = Node(after, home, chain_keys(after), genesis(after, chain_keys(after)),
                                None, items)
                    node.ours = our_key(after, node.keys, node.gen)
                    node.events = events
                    await node.open()
                    out["restart"] = {
                        "handshake_blocks": node.handshaker.n_blocks,
                        "same_precommit": node.cs.rs.votes.precommits(0).get_by_address(
                            ours.pub_key().address()).to_dict() == signed.to_dict(),
                    }
                    bid = node.ns.BlockID(node.cs.rs.proposal_block.hash(),
                                          node.cs.rs.proposal_block_parts.header())
                    await send(node, peer_votes(node, 2, h, 0, node.cs.rs.proposal_block, bid))
                    await until(node, lambda: node.cs.rs.height == h + 1, f"commit {h}")
                    break
                r += 1
            await delivered(node)
            out["heights"][h] = snapshot(node, h)
        await until(node, lambda: at(node, HEIGHTS + 1, 0, STEP.NEW_HEIGHT), "the last height")
    finally:
        await node.close()
    out["wal_files"] = sorted(os.listdir(os.path.join(home, "cs.wal")))
    return out


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


_runs = {}


def chain(first, after=None):
    key = (first.name, (after or first).name)
    if key not in _runs:
        _runs[key] = run(run_chain(first, after))
    return _runs[key]


# ---------------------------------------------------------------------------
# the 4-validator chain, per height
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", range(1, HEIGHTS + 1))
def test_consensus_heights_match_jax(h):
    ours, theirs = chain(PORT), chain(JAX)
    assert ours["checks"][h] == theirs["checks"][h]
    for key in ours["heights"][h]:
        assert ours["heights"][h][key] == theirs["heights"][h][key], key


@pytest.mark.parametrize("first,after", [(JAX, PORT), (PORT, JAX)], ids=["jax-port", "port-jax"])
def test_each_package_resumes_the_others_wal_stores_and_privval(first, after):
    """The node of `after` restarts mid-height on the WAL, stores and FilePV
    files that `first` left, and the chain is the one either package makes
    alone, height for height."""
    cross, alone = chain(first, after), chain(PORT)
    assert cross["restart"] == alone["restart"]
    for h in range(1, HEIGHTS + 1):
        for key in alone["heights"][h]:
            assert cross["heights"][h][key] == alone["heights"][h][key], (h, key)


def test_the_chain_took_the_designed_path():
    c = chain(PORT)
    hs = c["heights"]
    keys = chain_keys(PORT)
    ours = our_key(PORT, keys, genesis(PORT, keys))
    assert hs[OURS_AT]["proposer"] == ours.pub_key().address()
    assert [hs[h]["round"] for h in hs] == [int(h == WITHHELD_AT) for h in hs]
    assert [len(hs[h]["evidence"]) for h in hs] == [int(h == OURS_AT) for h in hs]
    assert hs[OURS_AT]["pending_evidence"] == 0
    assert all(hs[h]["last_commit"] == N_VALS for h in hs if h > 1)
    # the corrupted envelope rejected, the rest in the block
    for h in hs:
        assert [ck[0] for ck in c["checks"][h]] == ["ok", "ok", "ok", "MempoolError", "ok"]
        assert len(hs[h]["txs"]) == 4
    assert c["restart"] == {"handshake_blocks": 0, "same_precommit": True}
    kinds = [e[0] for e in hs[WITHHELD_AT]["events"]]
    assert "TimeoutPropose" in kinds and "TimeoutWait" in kinds
    assert kinds.count("NewBlock") == 1
    wal = hs[CRASH_AT]["wal"]
    ends = [r["height"] for r in wal if r["type"] == "endheight"]
    assert ends == list(range(1, HEIGHTS + 1))
    assert c["wal_files"] == ["wal"]


def test_aggregate_commit_input_names_the_bls_slice():
    """The aggregate catch-up input (ROADMAP 1.9's BLS slice) queues the
    commit for the receive routine as the JAX package does."""
    async def go(mod):
        cs = object.__new__(mod.ConsensusState)
        cs.msg_queue = asyncio.Queue()
        commit = object()
        await cs.add_agg_commit_input(commit, "peer-1")
        item = cs.msg_queue.get_nowait()
        assert item.pop("commit") is commit and cs.msg_queue.empty()
        return item

    got = [run(go(mod)) for mod in (jstate_machine, pstate_machine)]
    assert got[0] == got[1] == {"type": "agg_commit", "peer_id": "peer-1"}
