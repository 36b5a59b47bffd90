"""The port's consensus reactor (tendermint_tpu_torch/consensus/reactor.py)
against the JAX package's, tolerance 0, and the JAX package's
tests/test_gossip.py unit cases run on the port.

- Frame bytes: `vote_batch` (through `_send_vote_batch`), `new_round_step`
  (through `_new_round_step_msg`), `proposal`, `block_part` and
  `has_vote` for the same inputs in both packages.
- `PeerRoundState` after one message sequence; `_relay_targets` for the
  same ids, height and round (hypothesis).
- The gossip cases: one engine flush per batch, the direct path from 16
  votes, a bad signature stops the peer with the JAX reason, oversized and
  malformed frames, summary -> pull -> batch, capability gating,
  rarest-first parts, maj23 dedupe, the belief tables' bounds.
- The deviation (ROADMAP 3): an engine that raises its own error
  (crypto.batch.EngineError) in `verify_direct`, `verify_many` or
  `verify_one` raises p2p.LocalFault out of `receive` (the JAX reactor
  drops the frame, or stops the peer for a bad signature), and through a
  real connection the receive task fails.
"""

import asyncio
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tendermint_tpu.config as jconfig
import tendermint_tpu.consensus.reactor as jreactor
import tendermint_tpu.consensus.types as jtypes
import tendermint_tpu.libs.metrics as jmetrics
import tendermint_tpu.libs.tracing as jtracing
import tendermint_tpu.types as jt
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.types.part_set import PartSet as JPartSet
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch.consensus import reactor as preactor
from tendermint_tpu_torch.consensus import types as ptypes
from tendermint_tpu_torch.crypto.batch import EngineError
from tendermint_tpu_torch.crypto.batch_verifier import AsyncBatchVerifier, BatchVerifier
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding import codec
from tendermint_tpu_torch.libs import metrics as pmetrics
from tendermint_tpu_torch.libs import tracing as ptracing
from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.p2p import LocalFault
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.part_set import PartSet
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

CHAIN_ID = "gossip-test-chain"
VOTE_CHANNEL = preactor.VOTE_CHANNEL

PORT = SimpleNamespace(reactor=preactor, types=ptypes, config=pconfig, metrics=pmetrics,
                       tracing=ptracing, PrivKey=Ed25519PrivKey, Vote=Vote, BlockID=BlockID,
                       PartSetHeader=PartSetHeader, Proposal=Proposal, PartSet=PartSet,
                       Validator=Validator, ValidatorSet=ValidatorSet)
JAX = SimpleNamespace(reactor=jreactor, types=jtypes, config=jconfig, metrics=jmetrics,
                      tracing=jtracing, PrivKey=JPrivKey, Vote=jt.Vote, BlockID=jt.BlockID,
                      PartSetHeader=jt.PartSetHeader, Proposal=jt.Proposal, PartSet=JPartSet,
                      Validator=jt.Validator, ValidatorSet=jt.ValidatorSet)


class _CountingVerifier(BatchVerifier):
    """Host-path verifier counting engine calls: one call is one flush."""

    def __init__(self):
        super().__init__(device="cpu", min_device_batch=10**9)
        self.calls = []

    def start_warmup(self):
        return self

    def verify(self, pubkeys, msgs, sigs):
        self.calls.append(len(sigs))
        return super().verify(pubkeys, msgs, sigs)


class _FakeSwitch:
    def __init__(self):
        self.stopped = []

    async def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, reason))


def _fake_cs(pkg, vset, height=5):
    """The slice of ConsensusState the reactor's paths use."""
    cs = SimpleNamespace(
        config=pkg.config.ConsensusConfig(),
        rs=pkg.types.RoundState(height=height, validators=vset,
                                votes=pkg.types.HeightVoteSet(CHAIN_ID, height, vset),
                                last_validators=None),
        sm_state=SimpleNamespace(chain_id=CHAIN_ID), on_new_round_step=[], on_vote=[],
        on_valid_block=[], on_proposal=[], on_new_block_part=[],
        metrics=pkg.metrics.ConsensusMetrics(), recorder=pkg.tracing.NOP, added=[])

    async def add_vote_input(vote, peer_id="", verified=False):
        cs.added.append((vote, peer_id, verified))

    cs.add_vote_input = add_vote_input
    return cs


def _seeds(n):
    return [bytes([i + 1]) * 32 for i in range(n)]


def _vset_and_votes(pkg=PORT, n=4, height=5, vote_type=PREVOTE_TYPE, ts=1):
    """n validators at power 10 from fixed seeds, and each one's signed vote
    (the same bytes in both packages)."""
    keys = [pkg.PrivKey(s) for s in _seeds(n)]
    vset = pkg.ValidatorSet([pkg.Validator.new(k.pub_key(), 10) for k in keys])
    votes = []
    for k in sorted(keys, key=lambda k: k.pub_key().address()):
        i, _ = vset.get_by_address(k.pub_key().address())
        v = pkg.Vote(type=vote_type, height=height, round=0, block_id=pkg.BlockID(),
                     timestamp_ns=ts, validator_address=k.pub_key().address(), validator_index=i)
        v.signature = k.sign(v.sign_bytes(CHAIN_ID))
        votes.append(v)
    return vset, votes


def _batch_msg(votes):
    return preactor._enc("vote_batch", {"votes": [v.wire() for v in votes]})


class _CapturePeer:
    """A fake peer capturing every (chan, decoded kind, fields, raw) send."""

    def __init__(self, pid, gossip_version=2):
        self.id = pid
        self.gossip_version = gossip_version
        self.sent = []

    async def send(self, chan, msg):
        d = codec.loads(msg)
        self.sent.append((chan, d.pop("k"), d, msg))
        return True

    def kinds(self):
        return [k for _, k, _, _ in self.sent]


# -- frame bytes against the JAX package ---------------------------------------


@pytest.mark.parametrize("gossip_version", [1, 3])
async def test_vote_batch_frame_bytes_equal_jax(gossip_version):
    frames = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        vset, votes = _vset_and_votes(pkg, n=6)
        cs = _fake_cs(pkg, vset)
        cs.config.gossip_trace_context = False  # the stamp's wall clock differs
        for v in votes[:4]:
            cs.rs.votes.add_vote(v, verify=False)
        reactor = pkg.reactor.ConsensusReactor(cs)
        peer = _CapturePeer("ab" * 20, gossip_version)
        ps = pkg.reactor.PeerRoundState()
        ps.height = 5
        assert await reactor._send_vote_batch(peer, ps, votes, 6,
                                              have=cs.rs.votes.prevotes(0))
        frames[name] = peer.sent[-1][3]
        assert [ps.get_vote_bits(5, 0, PREVOTE_TYPE, 6).get_index(i) for i in range(6)] == \
            [True] * 6
    assert frames["port"] == frames["jax"]


def test_state_and_data_frame_bytes_equal_jax():
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        vset, votes = _vset_and_votes(pkg, n=4)
        cs = _fake_cs(pkg, vset)
        cs.rs.step = pkg.types.RoundStep.PREVOTE
        cs.rs.round = 2
        cs.rs.start_time = 1e12  # seconds_since_start clamps to 0.0
        reactor = pkg.reactor.ConsensusReactor(cs)
        key = pkg.PrivKey(_seeds(1)[0])
        parts = pkg.PartSet.from_data(bytes(range(256)) * 700, 65536)
        prop = pkg.Proposal(height=5, round=2, pol_round=-1,
                            block_id=pkg.BlockID(b"\x07" * 32, parts.header()),
                            timestamp_ns=1_700_000_000 * 10**9)
        prop.signature = key.sign(prop.sign_bytes(CHAIN_ID))
        enc = pkg.reactor._enc
        out[name] = [
            reactor._new_round_step_msg(),
            enc("proposal", {"proposal": prop.to_dict()}),
            reactor._part_frame(5, 2, parts.get_part(1)),
            enc("has_vote", {"height": 5, "round": 2, "vote_type": PREVOTE_TYPE, "index": 3}),
            enc("vote", {"vote": votes[0].to_dict()}),
        ]
    assert out["port"] == out["jax"]
    kind, msg = preactor._dec(out["port"][0])
    assert kind == "new_round_step" and msg["seconds_since_start"] == 0.0


MSGS = [
    {"k": "nrs", "height": 5, "round": 0, "step": 3, "last_commit_round": 0},
    {"k": "hv", "height": 5, "round": 0, "type": PREVOTE_TYPE, "index": 2},
    {"k": "hv", "height": 5, "round": 1, "type": PRECOMMIT_TYPE, "index": 3},
    {"k": "nvb", "height": 5, "round": 0, "is_commit": False},
    {"k": "prop", "height": 5, "round": 0},
    {"k": "part", "height": 5, "round": 0, "index": 1},
    {"k": "vsb", "height": 5, "round": 0, "type": PREVOTE_TYPE, "bits": [0, 1]},
    {"k": "nrs", "height": 6, "round": 0, "step": 1, "last_commit_round": 1},
    {"k": "hv", "height": 5, "round": 1, "type": PRECOMMIT_TYPE, "index": 0},
    {"k": "nrs", "height": 6, "round": 2, "step": 4, "last_commit_round": 1},
]


def _apply(pkg, ps, m, parts_header, proposal):
    if m["k"] == "nrs":
        ps.apply_new_round_step({k: m[k] for k in ("height", "round", "step",
                                                   "last_commit_round")})
    elif m["k"] == "hv":
        ps.set_has_vote(m["height"], m["round"], m["type"], m["index"], 4)
    elif m["k"] == "nvb":
        ps.apply_new_valid_block({"height": m["height"], "round": m["round"],
                                  "is_commit": m["is_commit"],
                                  "block_parts_header": parts_header.to_dict(),
                                  "block_parts": BitArray.from_indices(3, [0]).to_bytes()})
    elif m["k"] == "prop":
        ps.set_has_proposal(proposal)
    elif m["k"] == "part":
        ps.set_has_proposal_block_part(m["height"], m["round"], m["index"])
    elif m["k"] == "vsb":
        ps.apply_vote_set_bits({"height": m["height"], "round": m["round"], "type": m["type"],
                                "votes": BitArray.from_indices(4, m["bits"]).to_bytes()},
                               None, 4)


def _snapshot(ps):
    def bits(b):
        return None if b is None else [b.get_index(i) for i in range(b.bits)]

    return (ps.height, ps.round, ps.step, ps.proposal, ps.proposal_pol_round,
            None if ps.proposal_block_parts_header is None
            else ps.proposal_block_parts_header.to_dict(),
            bits(ps.proposal_block_parts), ps.last_commit_round, bits(ps.last_commit),
            {r: bits(b) for r, b in ps.prevotes.items()},
            {r: bits(b) for r, b in ps.precommits.items()})


def test_peer_round_state_after_the_same_messages_equals_jax():
    trace = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        header = pkg.PartSetHeader(3, b"\x09" * 32)
        proposal = pkg.Proposal(height=5, round=0, pol_round=-1,
                                block_id=pkg.BlockID(b"\x08" * 32, header))
        ps = pkg.reactor.PeerRoundState()
        trace[name] = []
        for m in MSGS:
            _apply(pkg, ps, m, header, proposal)
            trace[name].append(_snapshot(ps))
    assert trace["port"] == trace["jax"]
    assert trace["port"][-1][0:3] == (6, 2, 4)


def _relay_reactor(pkg, ids, me, degree, min_peers):
    vset, _ = _vset_and_votes(pkg, n=2)
    cs = _fake_cs(pkg, vset)
    cs.config.gossip_relay_degree = degree
    cs.config.gossip_relay_min_peers = min_peers
    reactor = pkg.reactor.ConsensusReactor(cs)
    reactor.switch = SimpleNamespace(node_id=me, peers={})
    for pid in ids:
        reactor.peer_states[pid] = pkg.reactor.PeerRoundState()
    return reactor


_ID = st.binary(min_size=20, max_size=20).map(bytes.hex)


@settings(max_examples=60, deadline=None)
@given(ids=st.lists(_ID, min_size=0, max_size=30, unique=True), me=_ID,
       height=st.integers(1, 10**6), round_=st.integers(0, 50), degree=st.integers(0, 10),
       min_peers=st.integers(0, 15))
def test_relay_targets_equal_jax(ids, me, height, round_, degree, min_peers):
    got = _relay_reactor(PORT, ids, me, degree, min_peers)._relay_targets(height, round_)
    want = _relay_reactor(JAX, ids, me, degree, min_peers)._relay_targets(height, round_)
    assert got == want


# -- tests/test_gossip.py's cases on the port -----------------------------------


def test_wire_encode_once_and_roundtrip():
    _, votes = _vset_and_votes(n=2)
    w1 = votes[0].wire()
    assert votes[0].wire() is w1
    back = codec.loads(w1)
    assert isinstance(back, Vote) and back == votes[0]


async def test_single_flush_for_whole_batch():
    cv = _CountingVerifier()
    svc = AsyncBatchVerifier(cv)
    await svc.start()
    try:
        keys = [Ed25519PrivKey.from_secret(b"vm%d" % i) for i in range(50)]
        items = [(k.pub_key().bytes(), b"payload-%d" % i, k.sign(b"payload-%d" % i))
                 for i, k in enumerate(keys)]
        items[7] = (items[7][0], items[7][1], bytes(64))
        results = await asyncio.gather(*svc.verify_many(items))
        assert cv.calls == [50]
        assert results[7] is False and all(r for i, r in enumerate(results) if i != 7)
    finally:
        await svc.stop()


async def _receive_batch(votes, vset, verifier=None, gossip_version=1):
    cs = _fake_cs(PORT, vset)
    svc = AsyncBatchVerifier(verifier or _CountingVerifier())
    await svc.start()
    try:
        reactor = preactor.ConsensusReactor(cs, async_verifier=svc)
        reactor.switch = _FakeSwitch()
        peer = SimpleNamespace(id="batch-peer-0000", gossip_version=gossip_version)
        reactor.peer_states[peer.id] = preactor.PeerRoundState()
        await reactor.receive(VOTE_CHANNEL, peer, _batch_msg(votes))
        return cs, reactor
    finally:
        await svc.stop()


async def test_batch_is_one_engine_flush_and_lands_verified():
    vset, votes = _vset_and_votes(n=4)
    cv = _CountingVerifier()
    cs, reactor = await _receive_batch(votes, vset, cv)
    assert cv.calls == [4]
    assert len(cs.added) == 4 and all(verified for _, _, verified in cs.added)
    assert reactor.switch.stopped == []


async def test_large_batch_rides_the_direct_engine_path():
    n = preactor.DIRECT_VERIFY_MIN + 4
    vset, votes = _vset_and_votes(n=n)
    cv = _CountingVerifier()
    cs, _ = await _receive_batch(votes, vset, cv, gossip_version=2)
    assert cv.calls == [n]
    assert len(cs.added) == n and all(verified for _, _, verified in cs.added)


@pytest.mark.parametrize("n", [4, preactor.DIRECT_VERIFY_MIN + 2])
async def test_bad_signature_in_batch_stops_peer_with_the_jax_reason(n):
    vset, votes = _vset_and_votes(n=n)
    votes[2].signature = bytes([votes[2].signature[0] ^ 1]) + votes[2].signature[1:]
    cs, reactor = await _receive_batch(votes, vset)
    assert reactor.switch.stopped == [("batch-peer-0000", "invalid vote signature in batch")]
    assert cs.added == []


async def test_oversized_and_malformed_batches_stop_peer():
    vset, votes = _vset_and_votes(n=1)
    reactor = preactor.ConsensusReactor(_fake_cs(PORT, vset), async_verifier=None)
    reactor.switch = _FakeSwitch()
    peer = SimpleNamespace(id="flood-peer-0000", gossip_version=1)
    reactor.peer_states[peer.id] = preactor.PeerRoundState()
    await reactor.receive(VOTE_CHANNEL, peer, preactor._enc(
        "vote_batch", {"votes": [votes[0].wire()] * 16385}))
    await reactor.receive(VOTE_CHANNEL, peer, preactor._enc("vote_batch", {"votes": 7}))
    await reactor.receive(VOTE_CHANNEL, peer, preactor._enc(
        "vote_batch", {"votes": [codec.dumps({"not": "a vote"})]}))
    await reactor.receive(VOTE_CHANNEL, peer, b"\xc1 not a codec frame")
    reasons = [r for _, r in reactor.switch.stopped]
    assert reasons[:2] == ["malformed vote_batch"] * 2
    assert reasons[2].startswith("invalid vote in batch:")
    assert reasons[3] == "malformed consensus message"


def test_pick_parts_prefers_parts_fewest_peers_hold():
    vset, _ = _vset_and_votes(n=2)
    reactor = preactor.ConsensusReactor(_fake_cs(PORT, vset))
    header = PartSetHeader(4, b"\x01" * 32)
    ps, other = preactor.PeerRoundState(), preactor.PeerRoundState()
    ps.proposal_block_parts_header = other.proposal_block_parts_header = header
    ps.proposal_block_parts = BitArray(4)
    other.proposal_block_parts = BitArray.from_indices(4, [0, 1])
    reactor.peer_states = {"a": ps, "b": other}
    missing = BitArray.from_indices(4, range(4))
    assert set(reactor._pick_parts(missing, ps, 2)) == {2, 3}
    assert len(reactor._pick_parts(missing, ps, 3)) == 3


async def test_identical_maj23_claim_sent_once_then_expires():
    vset, _ = _vset_and_votes(n=2)
    cs = _fake_cs(PORT, vset)
    reactor = preactor.ConsensusReactor(cs)
    peer, ps = _CapturePeer("maj23-peer-0000"), preactor.PeerRoundState()
    bid = BlockID(b"\x05" * 32, PartSetHeader(1, b"\x06" * 32))
    await reactor._maybe_send_maj23(peer, ps, 5, 0, PREVOTE_TYPE, bid)
    await reactor._maybe_send_maj23(peer, ps, 5, 0, PREVOTE_TYPE, bid)
    assert len(peer.sent) == 1
    ps.maj23_sent[(5, 0, PREVOTE_TYPE, bid.key())] -= (
        10 * cs.config.peer_query_maj23_sleep_duration + 1)
    await reactor._maybe_send_maj23(peer, ps, 5, 0, PREVOTE_TYPE, bid)
    assert len(peer.sent) == 2
    ps.apply_new_round_step({"height": 6, "round": 0, "step": 1})
    assert ps.maj23_sent == {}


async def test_summary_pull_batch_roundtrip():
    vset, votes = _vset_and_votes(n=4)
    cs_a = _fake_cs(PORT, vset)
    cs_a.config.gossip_relay_degree = 1
    cs_a.config.gossip_relay_min_peers = 1
    for v in votes:
        cs_a.rs.votes.add_vote(v, verify=False)
    vs_a = cs_a.rs.votes.prevotes(0)
    reactor_a = preactor.ConsensusReactor(cs_a)
    reactor_a.switch = _FakeSwitch()
    peer_b, ps_b = _CapturePeer("bb" * 20), preactor.PeerRoundState()
    ps_b.height = 5
    reactor_a.peer_states[peer_b.id] = ps_b
    reactor_a.peer_states["ff" * 20] = preactor.PeerRoundState()
    assert await reactor_a._send_votes(peer_b, ps_b, vs_a)
    chan, kind, frame, raw = peer_b.sent[-1]
    assert (chan, kind) == (0x20, "vote_summary")
    assert not await reactor_a._send_votes(peer_b, ps_b, vs_a)

    cs_b = _fake_cs(PORT, vset)
    reactor_b = preactor.ConsensusReactor(cs_b)
    reactor_b.switch = _FakeSwitch()
    peer_a, ps_a = _CapturePeer("aa" * 20), preactor.PeerRoundState()
    ps_a.height = 5
    reactor_b.peer_states[peer_a.id] = ps_a
    await reactor_b.receive(0x20, peer_a, raw)
    chan, kind, pull, pull_raw = peer_a.sent[-1]
    assert (chan, kind) == (0x23, "vote_pull")
    assert BitArray.from_bytes(pull["want"]).count() == 4
    assert peer_a.id in cs_b.rs.votes.prevotes(0).peer_maj23s
    await reactor_a.receive(0x23, peer_b, pull_raw)
    chan, kind, batch, batch_raw = peer_b.sent[-1]
    assert (chan, kind) == (0x22, "vote_batch") and len(batch["votes"]) == 4
    cv = _CountingVerifier()
    svc = AsyncBatchVerifier(cv)
    await svc.start()
    try:
        reactor_b.async_verifier = svc
        await reactor_b.receive(VOTE_CHANNEL, peer_a, batch_raw)
        assert cv.calls == [4] and len(cs_b.added) == 4
    finally:
        await svc.stop()


@pytest.mark.parametrize("gossip_version", [0, 1])
async def test_capability_gating(gossip_version):
    """A v1 peer gets vote_batch streams, not summaries; a v0 peer the
    single-vote messages."""
    vset, votes = _vset_and_votes(n=4)
    cs = _fake_cs(PORT, vset)
    cs.config.gossip_relay_degree = 1
    cs.config.gossip_relay_min_peers = 1
    for v in votes:
        cs.rs.votes.add_vote(v, verify=False)
    reactor = preactor.ConsensusReactor(cs)
    reactor.switch = _FakeSwitch()
    peer, ps = _CapturePeer("cc" * 20, gossip_version=gossip_version), preactor.PeerRoundState()
    ps.height = 5
    reactor.peer_states[peer.id] = ps
    reactor.peer_states["ff" * 20] = preactor.PeerRoundState()
    assert await reactor._send_votes(peer, ps, cs.rs.votes.prevotes(0))
    assert peer.kinds() == ["vote_batch" if gossip_version else "vote"]


async def test_malformed_summary_and_pull_stop_peer():
    vset, _ = _vset_and_votes(n=4)
    reactor = preactor.ConsensusReactor(_fake_cs(PORT, vset))
    reactor.switch = _FakeSwitch()
    peer = _CapturePeer("dd" * 20)
    reactor.peer_states[peer.id] = preactor.PeerRoundState()
    await reactor.receive(0x20, peer, preactor._enc("vote_summary", {
        "height": 5, "round": 0, "type": PREVOTE_TYPE, "block_id": {}, "votes": 123}))
    await reactor.receive(0x23, peer, preactor._enc("vote_pull", {
        "height": "x", "round": 0, "type": PREVOTE_TYPE, "want": b""}))
    assert [r for _, r in reactor.switch.stopped] == ["malformed vote_summary",
                                                      "malformed vote_pull"]


def test_peer_state_bounds():
    ps = preactor.PeerRoundState()
    ps.height = 5
    cap = preactor.PeerRoundState.MAX_TRACKED_ROUNDS
    for r in range(cap * 3):
        ps.get_vote_bits(5, r, PREVOTE_TYPE, 4)
    assert len(ps.prevotes) == cap and min(ps.prevotes) == cap * 2
    assert ps.get_vote_bits(5, 0, PREVOTE_TYPE, 4) is None
    huge = (2**31).to_bytes(4, "big") + b"\xff" * 8
    ps.apply_vote_set_bits({"height": 5, "round": cap * 3, "type": PRECOMMIT_TYPE,
                            "votes": huge}, None, num_validators=4)
    assert ps.precommits[cap * 3].bits <= 4


async def test_aggregate_commit_frames_are_not_ported():
    """A malformed `agg_commit` frame stops the peer with the JAX reason
    and reaches no consensus input; `_send_agg_commit` for a commit of
    another height than the peer's sends nothing, in both packages."""
    seen = {}
    for pkg in (JAX, PORT):
        vset, _ = _vset_and_votes(pkg, n=2)
        cs = _fake_cs(pkg, vset)
        fed = []

        async def add_agg_commit_input(commit, peer_id="", fed=fed):
            fed.append(commit)

        cs.add_agg_commit_input = add_agg_commit_input
        reactor = pkg.reactor.ConsensusReactor(cs)
        reactor.switch = _FakeSwitch()
        peer = _CapturePeer("ee" * 20)
        reactor.peer_states[peer.id] = pkg.reactor.PeerRoundState()
        await reactor.receive(VOTE_CHANNEL, peer, pkg.reactor._enc("agg_commit", {"commit": {}}))
        other = SimpleNamespace(height=9)
        sent = await reactor._send_agg_commit(peer, pkg.reactor.PeerRoundState(), other)
        seen[pkg is PORT] = (reactor.switch.stopped, fed, sent, peer.sent)
    assert seen[True] == seen[False]
    assert seen[True][0] == [("ee" * 20, "invalid agg_commit: 'height'")] and not seen[True][2]


# -- the deviation: engine errors reach the caller --------------------------------


class _BrokenLane:
    """An AsyncBatchVerifier whose engine raises its own error type."""

    def __init__(self):
        self.calls = []

    async def verify_direct(self, entries):
        self.calls.append(("direct", len(entries)))
        raise EngineError("the card fell off the bus")

    def verify_many(self, entries):
        self.calls.append(("many", len(entries)))
        loop = asyncio.get_running_loop()
        futs = [loop.create_future() for _ in entries]
        for f in futs:
            f.set_exception(EngineError("the card fell off the bus"))
        return futs

    async def verify_one(self, pk, msg, sig):
        self.calls.append(("one", 1))
        raise EngineError("the card fell off the bus")


@pytest.mark.parametrize("n", [4, preactor.DIRECT_VERIFY_MIN])
async def test_engine_error_in_a_batch_propagates_where_jax_drops_the_frame(n):
    frames = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        vset, votes = _vset_and_votes(pkg, n=n)
        cs = _fake_cs(pkg, vset)
        lane = _BrokenLane()
        reactor = pkg.reactor.ConsensusReactor(cs, async_verifier=lane)
        reactor.switch = _FakeSwitch()
        peer = SimpleNamespace(id="engine-peer-000", gossip_version=1)
        reactor.peer_states[peer.id] = pkg.reactor.PeerRoundState()
        msg = pkg.reactor._enc("vote_batch", {"votes": [v.wire() for v in votes]})
        frames[name] = msg
        if name == "jax":
            await reactor.receive(VOTE_CHANNEL, peer, msg)  # dropped silently
        else:
            with pytest.raises(LocalFault, match="the card fell off the bus"):
                await reactor.receive(VOTE_CHANNEL, peer, msg)
        assert lane.calls == [("direct" if n >= preactor.DIRECT_VERIFY_MIN else "many", n)]
        assert reactor.switch.stopped == [] and cs.added == []
    assert frames["port"] == frames["jax"]


async def test_engine_error_on_a_single_vote_propagates_where_jax_stops_the_peer():
    for name, pkg in (("port", PORT), ("jax", JAX)):
        vset, votes = _vset_and_votes(pkg, n=2)
        cs = _fake_cs(pkg, vset)
        reactor = pkg.reactor.ConsensusReactor(cs, async_verifier=_BrokenLane())
        reactor.switch = _FakeSwitch()
        peer = SimpleNamespace(id="single-peer-000", gossip_version=0)
        reactor.peer_states[peer.id] = pkg.reactor.PeerRoundState()
        msg = pkg.reactor._enc("vote", {"vote": votes[0].to_dict()})
        if name == "jax":
            await reactor.receive(VOTE_CHANNEL, peer, msg)
            assert reactor.switch.stopped == [(peer.id, "invalid vote signature")]
        else:
            with pytest.raises(LocalFault):
                await reactor.receive(VOTE_CHANNEL, peer, msg)
            assert reactor.switch.stopped == []
        assert cs.added == []


async def test_engine_error_fails_the_connections_receive_task():
    """Through a real link: the frame's LocalFault fails the port peer's
    MConnection receive task (logged at ERROR); the peer is not stopped
    for it and the switch stays up."""
    import logging

    from tendermint_tpu_torch.p2p.test_util import (
        connect_switches,
        make_switch,
        start_switch,
        stop_switches,
    )

    vset, votes = _vset_and_votes(n=4)
    cs = _fake_cs(PORT, vset)

    async def noop():
        pass

    cs.start, cs.is_running = noop, False  # the reactor starts and stops its cs
    reactor = preactor.ConsensusReactor(cs, async_verifier=_BrokenLane())
    sw1, sw2 = make_switch(), make_switch()
    sw1.add_reactor("CONSENSUS", reactor)

    class Sender(preactor.Reactor):
        def get_channels(self):
            return preactor.ConsensusReactor.get_channels(None)

    sw2.add_reactor("CONSENSUS", Sender("sender"))
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    keep = Keep(logging.ERROR)
    logging.getLogger().addHandler(keep)
    await start_switch(sw1)
    await start_switch(sw2)
    try:
        await connect_switches(sw2, sw1)
        peer1 = sw1.peers[sw2.node_id]
        recv = next(t for t in peer1.mconn._tasks if t.get_name() == "recv")
        await sw2.peers[sw1.node_id].send(VOTE_CHANNEL, _batch_msg(votes))
        await asyncio.wait_for(asyncio.wait({recv}), 10.0)
        assert isinstance(recv.exception(), LocalFault)
        assert sw2.node_id in sw1.peers and reactor.is_running
        msgs = [r.getMessage() for r in records]
        assert any("vote_batch verify failed in the engine" in m for m in msgs)
        assert any("task recv crashed" in m for m in msgs)
    finally:
        logging.getLogger().removeHandler(keep)
        await stop_switches([sw1, sw2])
