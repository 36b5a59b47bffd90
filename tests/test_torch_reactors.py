"""The port's mempool, evidence and fast-sync reactors and the flowrate
meters (tendermint_tpu_torch/mempool_reactor.py, evidence_reactor.py,
fastsync/reactor.py, p2p/behaviour.py, libs/flowrate.py) against the JAX
package's, tolerance 0, and the JAX package's cases for them run on the
port (tests/test_consensus_net.py's evidence withholding,
tests/test_fastsync.py's behaviour reporting and non-validator sync).

The mempool and fast-sync reactors' deviations (ROADMAP 3) are pinned
here: a peer's tx whose check_tx fails in the verify engine itself
(crypto.batch.EngineError) raises p2p.LocalFault, where the JAX reactor
lets the error stop the peer; and a fast-sync pair whose commit check
raises EngineError raises p2p.LocalFault, where the JAX reactor reports the
delivering peer for an invalid block.  Every other error of a peer's data
blames the peer on both packages (ROADMAP faults 3.4 and 3.5, closed): a
nil or mistyped LastCommit through the real ValidatorSet.verify_commit,
and a str tx into the real Mempool with its signed-tx lane on.
"""

import asyncio
import time
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tendermint_tpu.encoding.codec as jcodec
import tendermint_tpu.fastsync.reactor as jfs_reactor
import tendermint_tpu.libs.flowrate as jflowrate
import tendermint_tpu.mempool_reactor as jmempool_reactor
import tendermint_tpu.types.validator as jvalidator
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.types import BlockID as JBlockID
from tendermint_tpu.types import PartSetHeader as JPartSetHeader
from tendermint_tpu.types import Vote as JVote
from tendermint_tpu.types.evidence import DuplicateVoteEvidence as JDuplicateVoteEvidence
from tendermint_tpu_torch import evidence_reactor as pevidence_reactor
from tendermint_tpu_torch import mempool_reactor as pmempool_reactor
from tendermint_tpu_torch.config import test_config as ptest_config
from tendermint_tpu_torch.crypto.batch import EngineError
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding import codec
from tendermint_tpu_torch.evidence import EvidencePool
from tendermint_tpu_torch.fastsync import reactor as pfs_reactor
from tendermint_tpu_torch.libs import flowrate as pflowrate
from tendermint_tpu_torch.libs.kvstore import open_db
from tendermint_tpu_torch.node import Node
from tendermint_tpu_torch.p2p import LocalFault
from tendermint_tpu_torch.p2p.behaviour import (
    BAD_MESSAGE,
    MESSAGE_OUT_OF_ORDER,
    MockReporter,
    SwitchReporter,
    bad_message,
    consensus_vote,
)
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PREVOTE_TYPE
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.params import BlockParams, ConsensusParams
from tendermint_tpu_torch.types.priv_validator import MockPV
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "reactor-test-chain"

# -- flowrate -------------------------------------------------------------------


def test_meter_and_token_bucket_equal_jax():
    steps = [(0.0, 100), (0.1, 4000), (0.6, 0), (0.7, 2500), (3.0, 10), (40.0, 1)]
    out = {}
    for name, mod in (("port", pflowrate), ("jax", jflowrate)):
        m = mod.Meter(now=0.0)
        bucket = mod.TokenBucket(1000, 2000, now=0.0)
        trace = []
        for t, n in steps:
            m.update(n, now=t)
            trace.append((m.status(now=t), bucket.allow(n, now=t), bucket.debit(n / 2, now=t),
                          bucket.retry_after(n, now=t)))
        out[name] = trace
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError):
        pflowrate.TokenBucket(0, 1)


# -- the mempool reactor -------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(0, 3000), max_size=40), cap=st.integers(1, 5000))
def test_chunk_txs_equal_jax(sizes, cap):
    txs = [bytes([i % 251]) * n for i, n in enumerate(sizes)]
    frames = pmempool_reactor.chunk_txs(txs, cap)
    assert frames == jmempool_reactor.chunk_txs(txs, cap)
    assert [codec.dumps({"txs": f}) for f in frames] == [
        jcodec.dumps({"txs": f}) for f in frames]


class _Mempool:
    """check_tx records (tx, sender) and answers per tx: a MempoolError (of
    the package under test), an engine error, or success."""

    def __init__(self, error):
        self.seen, self.error = [], error

    async def check_tx(self, tx, sender=""):
        self.seen.append((tx, sender))
        if tx.startswith(b"dup"):
            raise self.error("tx already exists in cache")
        if tx.startswith(b"engine"):
            raise EngineError("the card fell off the bus")


class _Switch:
    def __init__(self):
        self.stopped = []

    async def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, reason))


async def test_mempool_reactor_receive_marks_the_sender_and_pins_the_deviation():
    peer = SimpleNamespace(id="mempool-peer-00")
    for mod in (pmempool_reactor, jmempool_reactor):
        mp = _Mempool(mod.MempoolError)
        r = mod.MempoolReactor(mp)
        r.switch = _Switch()
        await r.receive(0x30, peer, codec.dumps({"txs": [b"a=1", b"dup", b"b=2"]}))
        assert mp.seen == [(b"a=1", peer.id), (b"dup", peer.id), (b"b=2", peer.id)]
        await r.receive(0x30, peer, b"\xc1")
        assert r.switch.stopped == [(peer.id, "malformed mempool message")]
        frame = codec.dumps({"txs": [b"engine-tx"]})
        if mod is pmempool_reactor:
            with pytest.raises(LocalFault, match="the card fell off the bus"):
                await r.receive(0x30, peer, frame)
        else:  # the JAX reactor lets it reach the connection, which stops the peer
            with pytest.raises(RuntimeError):
                await r.receive(0x30, peer, frame)


# -- the evidence reactor --------------------------------------------------------


def _evidence(pkg_vote, pkg_bid, pkg_psh, priv, ev_cls, height=5):
    def vote(fill):
        v = pkg_vote(type=PREVOTE_TYPE, height=height, round=0,
                     block_id=pkg_bid(fill * 32, pkg_psh(1, b"\x02" * 32)), timestamp_ns=1,
                     validator_address=priv.pub_key().address(), validator_index=0)
        v.signature = priv.sign(v.sign_bytes(CHAIN_ID))
        return v

    return ev_cls.from_votes(priv.pub_key(), vote(b"\x01"), vote(b"\x03"))


def test_evidence_frame_bytes_equal_jax():
    seed = b"\x11" * 32
    p = _evidence(Vote, BlockID, PartSetHeader, Ed25519PrivKey(seed), DuplicateVoteEvidence)
    j = _evidence(JVote, JBlockID, JPartSetHeader, JPrivKey(seed), JDuplicateVoteEvidence)
    assert codec.dumps({"evidence": [p]}) == jcodec.dumps({"evidence": [j]})
    assert p.hash() == j.hash()


async def test_evidence_withheld_until_peer_catches_up():
    sent = []
    ps = SimpleNamespace(height=3)

    class _Peer:
        id = "peer-ev"

        def get(self, key):
            return ps if key == "cs_peer_state" else None

        async def send(self, chan, msg):
            sent.append(codec.loads(msg)["evidence"])
            return True

    ev = _evidence(Vote, BlockID, PartSetHeader, Ed25519PrivKey(b"\x12" * 32),
                   DuplicateVoteEvidence)
    pool = EvidencePool(open_db("ev", None, "memdb"), StateStore(open_db("state", None, "memdb")))
    pool.pending_evidence = lambda max_num=-1: [ev]
    reactor = pevidence_reactor.EvidenceReactor(pool)
    await reactor.start()
    try:
        await reactor.add_peer(_Peer())
        await asyncio.sleep(0.3)
        assert sent == []  # withheld: the peer is at 3, the evidence at 5
        ps.height = 6
        await asyncio.sleep(0.3)
        assert len(sent) == 1 and sent[0][0].hash() == ev.hash()
        await asyncio.sleep(0.3)
        assert len(sent) == 1  # not re-sent
    finally:
        await reactor.stop()


# -- the fast-sync reactor --------------------------------------------------------


def test_blockchain_frames_equal_jax():
    for fields in (("status_request", {}), ("status_response", {"height": 7, "base": 1}),
                   ("block_request", {"height": 3}), ("no_block_response", {"height": 9})):
        assert pfs_reactor._enc(*fields) == jfs_reactor._enc(*fields)
        assert pfs_reactor._dec(pfs_reactor._enc(*fields)) == (fields[0], fields[1])


class _Store:
    def height(self):
        return 0

    def base(self):
        return 0


async def test_bad_and_unsolicited_block_responses_are_reported():
    reactor = pfs_reactor.BlockchainReactor.__new__(pfs_reactor.BlockchainReactor)
    reactor.reporter = MockReporter()
    reactor.fast_sync = True
    reactor.refill_heights = set()
    reactor.block_store = _Store()
    reactor.scheduler = SimpleNamespace(block_received=lambda pid, h: False)
    peer = SimpleNamespace(id="peerX")
    await reactor.receive(pfs_reactor.BLOCKCHAIN_CHANNEL, peer, b"\x00garbage")
    await reactor.receive(pfs_reactor.BLOCKCHAIN_CHANNEL, peer,
                          pfs_reactor._enc("block_response", {"block": b"not a block"}))
    assert [r.kind for r in reactor.reporter.get("peerX")] == [BAD_MESSAGE, BAD_MESSAGE]


class _EngineFault(EngineError):
    """The port engine's error type (a RuntimeError, as the JAX reactor
    sees it)."""


def _try_sync_reactor(mod, psh_cls, verify_error):
    """A fast-sync reactor with one pending pair whose commit check raises
    verify_error; records what the error path touches."""
    calls = []

    def verify_commit(*args):
        raise verify_error

    first = SimpleNamespace(
        height=4, hash=lambda: b"\x11" * 32,
        make_part_set=lambda size: SimpleNamespace(
            header=lambda: psh_cls(1, b"\x22" * 32)))
    second = SimpleNamespace(height=5, last_commit=object())
    reactor = mod.BlockchainReactor.__new__(mod.BlockchainReactor)
    reactor.log = mod.get_logger("fastsync")
    reactor.reporter = MockReporter()
    reactor.state = SimpleNamespace(
        chain_id=CHAIN_ID, validators=SimpleNamespace(verify_commit=verify_commit))
    reactor.processor = SimpleNamespace(
        peek_two=lambda: (first, second),
        drop_invalid=lambda: calls.append("drop_invalid") or [4, 5],
        drop_heights=lambda hs: calls.append(("drop_heights", list(hs))))
    reactor.scheduler = SimpleNamespace(
        block_invalid=lambda h: calls.append(("block_invalid", h)) or ("peer-sync-0", []))
    return reactor, calls


@pytest.mark.parametrize("kind", ["wrong-signature", "not-enough-power", "engine-fault"])
async def test_try_sync_blames_the_peer_only_for_a_bad_block(kind):
    """A bad commit (verify_commit's ValueError or NotEnoughVotingPowerError)
    drops the pair and reports the delivering peer on both packages.  An
    engine fault is reported the same way by the JAX reactor; the port's
    raises LocalFault and touches neither the processor nor the peer."""
    for mod, psh_cls, val_mod in ((pfs_reactor, PartSetHeader, pvalidator),
                                  (jfs_reactor, JPartSetHeader, jvalidator)):
        err = {
            "wrong-signature": ValueError("wrong signature (#3): 00"),
            "not-enough-power": val_mod.NotEnoughVotingPowerError(got=10, needed=20),
            "engine-fault": _EngineFault("the card fell off the bus"),
        }[kind]
        reactor, calls = _try_sync_reactor(mod, psh_cls, err)
        if kind == "engine-fault" and mod is pfs_reactor:
            with pytest.raises(LocalFault, match="the card fell off the bus"):
                await reactor._try_sync()
            assert calls == [] and reactor.reporter.get("peer-sync-0") == []
            continue
        await reactor._try_sync()
        assert calls[0] == "drop_invalid"
        assert ("block_invalid", 4) in calls and ("block_invalid", 5) in calls
        assert [(b.kind, b.explanation) for b in reactor.reporter.get("peer-sync-0")] == \
            [(BAD_MESSAGE, "sent invalid block")] * 2


async def test_switch_reporter_stops_bad_and_marks_good():
    stopped, marked = [], []

    class _Book:
        def mark_good(self, pid):
            marked.append(pid)

    class _Sw:
        peers = {"p1": object(), "p2": object()}
        addr_book = _Book()

        async def stop_peer_for_error(self, peer, reason):
            stopped.append(reason)

    rep = SwitchReporter(_Sw())
    assert await rep.report(consensus_vote("p1")) and marked == ["p1"]
    assert await rep.report(bad_message("p2", "bad")) and stopped == ["bad"]
    assert not await rep.report(bad_message("ghost", "x"))
    assert MESSAGE_OUT_OF_ORDER == "message_out_of_order"


def _cfg(home, fast_sync):
    cfg = ptest_config(home)
    cfg.rpc.laddr = ""
    cfg.base.db_backend = "memdb"
    cfg.base.fast_sync = fast_sync
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.consensus.skip_timeout_commit = False
    cfg.consensus.timeout_commit = 0.1
    return cfg


async def test_non_validator_fast_syncs_then_follows(tmp_path):
    """Three port validators commit; a non-validator port node with fast
    sync on joins, syncs the chain from them, switches to consensus and
    follows the head; the quarantine refill asks its peers for a block."""
    pvs = sorted((MockPV(Ed25519PrivKey(bytes([i + 1]) * 32)) for i in range(3)),
                 key=lambda pv: pv.address())
    gen = GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=1_700_000_000 * 10**9,
                     validators=[GenesisValidator(pv.address(), pv.get_pub_key(), 10)
                                 for pv in pvs],
                     consensus_params=ConsensusParams(block=BlockParams(time_iota_ms=1)))
    nodes = [Node(_cfg(str(tmp_path / f"v{i}"), False), gen, priv_validator=pv,
                  db_backend="memdb") for i, pv in enumerate(pvs)]
    syncer = Node(_cfg(str(tmp_path / "syncer"), True), gen, priv_validator=None,
                  db_backend="memdb")

    async def until(cond, timeout):
        async def wait():
            while not cond():
                await asyncio.sleep(0.05)

        await asyncio.wait_for(wait(), timeout)

    try:
        for n in nodes:
            await n.start()
        for i in range(3):
            for j in range(i + 1, 3):
                await nodes[i].switch.dial_peer(
                    f"{nodes[j].node_key.id}@{nodes[j].switch.transport.listen_addr}")
        await until(lambda: all(n.block_store.height() >= 4 for n in nodes), 40.0)
        await syncer.start()
        assert syncer.blockchain_reactor.fast_sync and syncer.consensus_reactor.wait_sync
        for n in nodes:
            await syncer.switch.dial_peer(f"{n.node_key.id}@{n.switch.transport.listen_addr}")
        target = nodes[0].block_store.height() + 3
        await until(lambda: syncer.block_store.height() >= target, 60.0)
        assert syncer.blockchain_reactor.blocks_synced > 0
        assert not syncer.blockchain_reactor.fast_sync
        assert not syncer.consensus_reactor.wait_sync and syncer.consensus.is_running
        for h in range(1, target):
            assert syncer.block_store.load_block(h).hash() == \
                nodes[0].block_store.load_block(h).hash()
        # a refill of a height no store quarantined: queued, asked of the
        # peers, and dropped for want of a surviving identity
        t0 = time.monotonic()
        syncer.blockchain_reactor.request_refill([2])
        await until(lambda: not syncer.blockchain_reactor.refill_heights, 10.0)
        assert time.monotonic() - t0 < 10.0
    finally:
        for n in nodes + [syncer]:
            if n.is_running:
                await n.stop()


# -- faults 3.4 and 3.5: a peer's malformed data blames the peer ---------------


def _real_try_sync_reactor(mod, ns, second, reporter, monkeypatch):
    """A fast-sync reactor holding the pair (block 4, `second`) of the
    7-validator chain of tests/test_torch_chain_types.py, its state the
    real one after height 3 (so verify_commit runs for real), and the
    chain's part size (so block 4's id is the one its commit signs)."""
    import test_torch_chain_types as tct

    monkeypatch.setattr(mod, "BLOCK_PART_SIZE_BYTES", tct.PART)
    c = tct.chain(ns)
    first = c["blocks"][4]
    calls = []
    reactor = mod.BlockchainReactor.__new__(mod.BlockchainReactor)
    reactor.log = mod.get_logger("fastsync")
    reactor.reporter = reporter
    reactor.state = c["states"][3]
    reactor.processor = SimpleNamespace(
        peek_two=lambda: (first, second),
        drop_invalid=lambda: calls.append("drop_invalid") or [4, 5],
        drop_heights=lambda hs: calls.append(("drop_heights", list(hs))))
    reactor.scheduler = SimpleNamespace(
        block_invalid=lambda h: calls.append(("block_invalid", h)) or ("peer-sync-0", []))
    return reactor, calls, c


@pytest.mark.parametrize("fault", ["nil-last-commit", "str-round"])
async def test_try_sync_blames_the_peer_for_a_malformed_last_commit(fault, monkeypatch):
    """Fault 3.4: block 5 with a nil LastCommit, or with a str round, goes
    through the real ValidatorSet.verify_commit on both packages' _try_sync.
    Neither raises; both drop the pair and report the delivering peer."""
    import copy

    import test_torch_chain_types as tct
    from tendermint_tpu.p2p.behaviour import MockReporter as JMockReporter

    for mod, ns, rep in ((pfs_reactor, tct.PORT, MockReporter()),
                         (jfs_reactor, tct.JAX, JMockReporter())):
        c = tct.chain(ns)
        second = copy.copy(c["blocks"][5])
        if fault == "nil-last-commit":
            second.last_commit = None
        else:
            d = c["blocks"][5].last_commit.to_dict()
            d["round"] = "0"
            second.last_commit = type(c["commits"][4]).from_dict(d)
        reactor, calls, _ = _real_try_sync_reactor(mod, ns, second, rep, monkeypatch)
        await reactor._try_sync()
        assert calls[0] == "drop_invalid", mod.__name__
        # the commit itself is sound: only the injected field fails
        c["states"][3].validators.verify_commit(
            tct.CHAIN, c["ids"][4], 4, c["blocks"][5].last_commit)
        assert [b.explanation for b in rep.get("peer-sync-0")] == ["sent invalid block"] * 2


async def test_try_sync_turns_only_an_engine_error_into_local_fault(monkeypatch):
    """The engine raising inside the real verify_commit (a kernel launch
    that fails, wrapped as crypto.batch.EngineError by the engine) is the
    one exception the port's _try_sync raises as LocalFault; the pair and
    the peer are untouched."""
    import test_torch_chain_types as tct
    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto.batch_verifier import BatchVerifier
    from tendermint_tpu_torch.ops import ed25519_cuda

    def launch_fails(*args, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ed25519_cuda, "verify_indexed", launch_fails)
    c = tct.chain(tct.PORT)
    reactor, calls, _ = _real_try_sync_reactor(pfs_reactor, tct.PORT, c["blocks"][5],
                                               MockReporter(), monkeypatch)
    bv = BatchVerifier(device="cpu").install()
    try:
        with pytest.raises(LocalFault, match="kernel launch failed") as ei:
            await reactor._try_sync()
        assert isinstance(ei.value.__cause__, EngineError)
    finally:
        batch_hook.set_verifier(None)
    assert calls == [] and reactor.reporter.get("peer-sync-0") == []
    assert bv.last_dispatch == {}  # the launch raised before its dispatch record


async def test_a_str_tx_from_a_peer_is_the_peers_fault():
    """Fault 3.5: the frame {"txs": ["a=1"]} (a str tx) into both packages'
    reactors on the real Mempool (kvstore app, sig_precheck on).  The JAX
    check_tx raises TypeError, which its connection reads as the peer's
    fault and stops it; the port's reactor stops the peer itself before
    check_tx, and raises nothing."""
    import tendermint_tpu.mempool as jmempool
    import tendermint_tpu.proxy as jproxy
    from tendermint_tpu_torch import mempool as pmempool
    from tendermint_tpu_torch import proxy as pproxy

    frame = codec.dumps({"txs": ["a=1"]})
    assert frame == jcodec.dumps({"txs": ["a=1"]})
    peer = SimpleNamespace(id="str-tx-peer-000")
    for name, mp_mod, proxy_mod, r_mod in (
            ("port", pmempool, pproxy, pmempool_reactor),
            ("jax", jmempool, jproxy, jmempool_reactor)):
        conns = proxy_mod.AppConns(proxy_mod.default_client_creator("kvstore"))
        await conns.start()
        try:
            mp = mp_mod.Mempool(conns.mempool(), {"sig_precheck": True})
            r = r_mod.MempoolReactor(mp)
            r.switch = _Switch()
            if name == "jax":
                with pytest.raises(TypeError):
                    await r.receive(0x30, peer, frame)
                assert r.switch.stopped == []  # its connection stops the peer
            else:
                await r.receive(0x30, peer, frame)
                assert r.switch.stopped == [(peer.id, "malformed mempool message")]
            assert mp.size() == 0
        finally:
            await conns.stop()
