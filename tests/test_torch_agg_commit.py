"""Aggregate (BLS) commits in the port (types/agg_commit.py and its
consumers) against the JAX package's, on BLS12-381 keys made from seeded
secrets and vote timestamps drawn with seeded numpy.  Tolerance exact:
bytes, hashes and verdicts equal; raised errors equal by type and message.

- Case by case with the JAX package's own aggregate-commit tests
  (tests/test_bls.py TestAggregateCommit): the fold and verify round trip,
  a forged aggregate, a mixed set, nil precommits, a minority aggregate and
  the catchup lane that drops it, trusting verify with `commit_vals`, the
  fold time's median, sign-domain separation and AggregateLastCommit.
- Across the packages: a dict (and its codec bytes) of either package's
  commit read by the other's `commit_from_dict`; `verify_commit_run` over a
  run of aggregate commits with a forged one in the middle; the reactor's
  `agg_commit` frame as sent and as read; the async lanes (state sync's
  pre-verify, liteserve's VerifyCache, `verify_bls_aggregates`) and lite2's
  skipping verification over aggregate commits.
- An in-process net of four port validators on the CPU (JAX
  TestBlsNets): every stored commit below the tip folds, a late
  non-validator with fast sync off catches up through the `agg_commit`
  lane, an empty one fast-syncs over the aggregate heights, and a
  restarted validator rebuilds its AggregateLastCommit.
"""

import asyncio
import dataclasses
import types

import numpy as np
import pytest

import tendermint_tpu.consensus.reactor as jreactor
import tendermint_tpu.consensus.state as jcs
import tendermint_tpu.crypto.bls.keys as jbls
import tendermint_tpu.crypto.bls.scheme as jscheme
import tendermint_tpu.fastsync.processor as jprocessor
import tendermint_tpu.libs.bitarray as jbits
import tendermint_tpu.lite2.verifier as jlite
import tendermint_tpu.state.state as jstate
import tendermint_tpu.types as jtypes
import tendermint_tpu.types.agg_commit as jagg
import tendermint_tpu.types.canonical as jcanonical
import tendermint_tpu.types.validator as jvalidator
from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu_torch.consensus import reactor as preactor
from tendermint_tpu_torch.consensus import state as pcs
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto.bls import keys as pbls
from tendermint_tpu_torch.crypto.bls import scheme as pscheme
from tendermint_tpu_torch.encoding import codec as pcodec
from tendermint_tpu_torch.fastsync import processor as pprocessor
from tendermint_tpu_torch.libs import bitarray as pbits
from tendermint_tpu_torch.lite2 import verifier as plite
from tendermint_tpu_torch.state import state as pstate
from tendermint_tpu_torch.types import agg_commit as pagg
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import canonical as pcanonical
from tendermint_tpu_torch.types import priv_validator as ppv
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import vote as pvote
from tendermint_tpu_torch.types import vote_set as pvote_set

from test_torch_chain_types import outcome

CHAIN = "agg-commit-parity"
T0 = 1_700_000_000_000_000_000
SEED = 2121


@dataclasses.dataclass
class _Ns:
    name: str
    agg: object
    Bls: object
    MockPV: object
    Validator: object
    ValidatorSet: object
    VoteSet: object
    Vote: object
    BlockID: object
    PartSetHeader: object
    Commit: object
    BitArray: object
    canonical: object
    validator: object
    state: object
    scheme: object
    processor: object
    cs: object
    reactor: object
    codec: object
    lite: object


PORT = _Ns("port", pagg, pbls.BlsPrivKey, ppv.MockPV, pvalidator.Validator,
           pvalidator.ValidatorSet, pvote_set.VoteSet, pvote.Vote, pblock.BlockID,
           pblock.PartSetHeader, pblock.Commit, pbits.BitArray, pcanonical, pvalidator, pstate,
           pscheme, pprocessor, pcs, preactor, pcodec, plite)
JAX = _Ns("jax", jagg, jbls.BlsPrivKey, jtypes.MockPV, jtypes.Validator, jtypes.ValidatorSet,
          jtypes.VoteSet, jtypes.Vote, jtypes.BlockID, jtypes.PartSetHeader, jtypes.Commit,
          jbits.BitArray, jcanonical, jvalidator, jstate, jscheme, jprocessor, jcs, jreactor,
          jcodec, jlite)


@pytest.fixture(autouse=True)
def _no_hooks_left():
    yield
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)


def block_id(ns, seed=b"\x01"):
    return ns.BlockID(hash=seed * 32, parts_header=ns.PartSetHeader(total=1, hash=seed * 32))


def bls_set(ns, n, tag=b"av", power=10):
    """(set, privvals in set order) of n BLS validators from seeded secrets."""
    pvs = sorted((ns.MockPV(ns.Bls.from_secret(tag + b"%d" % i)) for i in range(n)),
                 key=lambda pv: pv.get_pub_key().address())
    return ns.ValidatorSet([ns.Validator.new(pv.get_pub_key(), power) for pv in pvs]), pvs


def signed_vote(ns, pv, vset, height, round_, bid, ts):
    idx, _ = vset.get_by_address(pv.get_pub_key().address())
    vote = ns.Vote(type=ns.canonical.PRECOMMIT_TYPE, height=height, round=round_, block_id=bid,
                   timestamp_ns=ts, validator_address=pv.get_pub_key().address(),
                   validator_index=idx)
    pv.sign_vote(CHAIN, vote)
    return vote


def make_commit(ns, vset, pvs, height, round_, bid, nil=()):
    """Every member precommits (those at `nil` for nil) at seeded times."""
    offs = np.random.default_rng(SEED + height).integers(0, 5_000_000, len(pvs))
    vs = ns.VoteSet(CHAIN, height, round_, ns.canonical.PRECOMMIT_TYPE, vset)
    for i, pv in enumerate(pvs):
        vs.add_vote(signed_vote(ns, pv, vset, height, round_,
                                ns.BlockID() if i in nil else bid, T0 + int(offs[i])))
    return vs.make_commit()


def folded(ns, n=4, height=3, tag=b"av", nil=()):
    vset, pvs = bls_set(ns, n, tag)
    bid = block_id(ns)
    commit = make_commit(ns, vset, pvs, height, 0, bid, nil=nil)
    return vset, pvs, bid, commit, ns.agg.fold_commit(commit, vset, CHAIN)


def wire(agg):
    return agg.encode(), agg.hash(), agg.to_dict()


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# case by case with the JAX package's TestAggregateCommit
# ---------------------------------------------------------------------------


def test_fold_verify_roundtrip_equals_jax():
    got = {}
    for ns in (JAX, PORT):
        vset, _, bid, commit, agg = folded(ns)
        assert isinstance(agg, ns.agg.AggregateCommit) and agg.signers.count() == 4
        # O(1) size: one 96-byte signature and a bitmap
        assert len(agg.encode()) < len(b"".join(cs.signature for cs in commit.signatures)) + 100
        vset.verify_commit(CHAIN, bid, 3, agg)
        again = ns.agg.commit_from_dict(agg.to_dict())
        assert isinstance(again, ns.agg.AggregateCommit) and wire(again) == wire(agg)
        vset.verify_commit(CHAIN, bid, 3, again)
        assert type(ns.agg.commit_from_dict(commit.to_dict())) is ns.Commit
        got[ns.name] = (wire(agg), ns.codec.dumps(agg), repr(agg))
    assert got["port"] == got["jax"]


def _forgeries(ns):
    vset, pvs, bid, _, agg = folded(ns)
    bad = ns.agg.AggregateCommit(agg.height, agg.round, agg.block_id, agg.signers,
                                 agg.agg_sig[:-1] + bytes([agg.agg_sig[-1] ^ 1]),
                                 agg.timestamp_ns)
    two = ns.BitArray(4)
    two.set_index(0, True)
    two.set_index(1, True)
    msg = agg.sign_message(CHAIN)
    partial = ns.agg.AggregateCommit(3, 0, bid, two, ns.scheme.aggregate_signatures(
        [pvs[i].priv_key.sign(msg) for i in (0, 1)]), agg.timestamp_ns)
    short = ns.agg.AggregateCommit(3, 0, bid, agg.signers, agg.agg_sig[:95], agg.timestamp_ns)
    other_height = ns.agg.AggregateCommit(4, 0, bid, agg.signers, agg.agg_sig, agg.timestamp_ns)
    return [outcome(lambda c=c: vset.verify_commit(CHAIN, bid, 3, c))
            for c in (bad, partial, short, other_height)]


def test_forged_aggregate_is_rejected_with_the_jax_error():
    """A flipped signature bit, a valid aggregate of a minority, a short
    signature and another height: the same error class and message."""
    got = _forgeries(PORT)
    assert got == _forgeries(JAX)
    assert [g[0] for g in got] == ["ValueError", "NotEnoughVotingPowerError",
                                   "ValueError", "ValueError"]


def test_mixed_set_does_not_fold():
    for ns in (JAX, PORT):
        bls = [ns.MockPV(ns.Bls.from_secret(b"mx%d" % i)) for i in range(2)]
        eds = [ns.MockPV(_ed(ns).from_secret(b"mx-ed%d" % i)) for i in range(2)]
        pvs = sorted(bls + eds, key=lambda pv: pv.get_pub_key().address())
        vset = ns.ValidatorSet([ns.Validator.new(pv.get_pub_key(), 10) for pv in pvs])
        assert not ns.agg.set_is_uniform_bls(vset)
        bid = block_id(ns)
        commit = make_commit(ns, vset, pvs, 3, 0, bid)
        assert ns.agg.fold_commit(commit, vset, CHAIN) is None
        vset.verify_commit(CHAIN, bid, 3, commit)


def _ed(ns):
    if ns is JAX:
        from tendermint_tpu.crypto.keys import Ed25519PrivKey
    else:
        from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    return Ed25519PrivKey


def test_nil_precommits_stay_out_of_the_bitmap():
    got = {}
    for ns in (JAX, PORT):
        vset, _, bid, _, agg = folded(ns, nil=(3,))
        assert agg.signers.count() == 3 and not agg.signers.get_index(3)
        vset.verify_commit(CHAIN, bid, 3, agg)
        got[ns.name] = wire(agg)
    assert got["port"] == got["jax"]


def test_minority_aggregate_raises_the_power_error_and_catchup_drops_it():
    """A genuine minority aggregate (2 of 4 signers) raises
    NotEnoughVotingPowerError, which is not a ValueError; the consensus
    catchup lane drops it silently in both packages."""
    for ns in (JAX, PORT):
        vset, pvs = bls_set(ns, 4, tag=b"min")
        bid = block_id(ns)
        signers = ns.BitArray(4)
        signers.set_index(0, True)
        signers.set_index(1, True)
        agg = ns.agg.AggregateCommit(5, 0, bid, signers, b"\x00" * 96, 1)
        msg = agg.sign_message(CHAIN)
        agg.agg_sig = ns.scheme.aggregate_signatures([pvs[i].priv_key.sign(msg) for i in (0, 1)])
        with pytest.raises(ns.validator.NotEnoughVotingPowerError):
            vset.verify_commit(CHAIN, bid, 5, agg)
        cs = ns.cs.ConsensusState.__new__(ns.cs.ConsensusState)
        cs.rs = types.SimpleNamespace(height=5, validators=vset)
        cs.block_store = types.SimpleNamespace(height=lambda: 0)
        cs.sm_state = types.SimpleNamespace(chain_id=CHAIN)
        cs.log = types.SimpleNamespace(debug=lambda *a, **k: None)
        _run(cs._apply_aggregate_commit(agg, "malicious-peer"))


def _trusting(ns):
    vset, _, bid, _, agg = folded(ns, n=7, height=9)
    out = [outcome(lambda: vset.verify_commit_trusting(CHAIN, bid, 9, agg, commit_vals=vset)),
           outcome(lambda: vset.verify_commit_trusting(CHAIN, bid, 9, agg))]
    # a trusted set that shares 2 of the 7 signers: below 1/3 of its power
    small, _ = bls_set(ns, 7, tag=b"other")
    small = ns.ValidatorSet(small.validators[:5] + vset.validators[:2])
    out.append(outcome(lambda: small.verify_commit_trusting(CHAIN, bid, 9, agg,
                                                            commit_vals=vset)))
    # verify_future_commit: signature against the new set, tally on the old
    out.append(outcome(lambda: small.verify_future_commit(vset, CHAIN, bid, 9, agg)))
    out.append(outcome(lambda: vset.verify_future_commit(vset, CHAIN, bid, 9, agg)))
    return out


def test_trusting_verify_with_commit_vals():
    got = _trusting(PORT)
    assert got == _trusting(JAX)
    assert got[0] == ("ok", None) and got[1][0] == "ValueError" and got[4] == ("ok", None)
    assert got[2][0] == got[3][0] == "NotEnoughVotingPowerError"


def test_median_time_is_the_fold_times_median():
    got = {}
    for ns in (JAX, PORT):
        vset, _, _, commit, agg = folded(ns)
        assert ns.state.median_time(agg, vset) == agg.timestamp_ns
        assert agg.timestamp_ns == ns.state.median_time(commit, vset)
        got[ns.name] = agg.timestamp_ns
    assert got["port"] == got["jax"]


def test_sign_domain_separation():
    """Timestamp-free bytes never equal the timestamped layout, and the
    aggregate's message is the packages' common timestamp-free layout."""
    got = {}
    for ns in (JAX, PORT):
        bid = block_id(ns)
        c = ns.canonical
        out = []
        for ts in (0, 1, 123456789):
            with_ts = c.canonical_vote_sign_bytes(CHAIN, c.PRECOMMIT_TYPE, 5, 0, bid.hash,
                                                  bid.parts_header.total,
                                                  bid.parts_header.hash, ts)
            without = c.canonical_vote_sign_bytes_no_ts(CHAIN, c.PRECOMMIT_TYPE, 5, 0, bid.hash,
                                                        bid.parts_header.total,
                                                        bid.parts_header.hash)
            assert with_ts != without
            out.append((with_ts, without))
        agg = ns.agg.AggregateCommit(5, 0, bid, ns.BitArray(1), b"", 1)
        assert agg.sign_message(CHAIN) == out[0][1]
        got[ns.name] = out
    assert got["port"] == got["jax"]


def test_aggregate_last_commit_surface():
    got = {}
    for ns in (JAX, PORT):
        _, _, bid, _, agg = folded(ns, nil=(2,))
        alc = ns.agg.AggregateLastCommit(agg)
        assert alc.has_two_thirds_majority() and alc.two_thirds_majority() == (bid, True)
        assert alc.make_commit() is agg and alc.add_vote(None) is False
        assert alc.missing_votes(None) == [] and alc.select_votes(None) == []
        assert alc.get_by_index(0) is None and alc.bits_we_lack(None).bits == 0
        assert alc.signed_msg_type == ns.canonical.PRECOMMIT_TYPE
        # the per-slot view ABCI's LastCommitInfo reads
        flags = [cs.block_id_flag for cs in agg.signatures]
        got[ns.name] = (alc.has_all(), alc.size(), alc.bit_array().to_bytes(), alc.height,
                        alc.round, repr(alc), flags, agg.get_vote(0), agg.is_commit())
    assert got["port"] == got["jax"]
    assert got["port"][0] is False and got["port"][6] == [2, 2, 1, 2]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def test_each_packages_dict_and_codec_bytes_read_in_the_other():
    jset, _, _, _, jagg_c = folded(JAX)
    _, _, _, _, pagg_c = folded(PORT)
    ours = pagg.commit_from_dict(jagg_c.to_dict())
    theirs = jagg.commit_from_dict(pagg_c.to_dict())
    assert wire(ours) == wire(jagg_c) == wire(pagg_c) == wire(theirs)
    # the stores' codec bytes, both ways
    assert pcodec.dumps(pcodec.loads(jcodec.dumps(jagg_c))) == jcodec.dumps(jagg_c)
    assert jcodec.dumps(jcodec.loads(pcodec.dumps(pagg_c))) == pcodec.dumps(pagg_c)
    # a SignedHeader-shaped dict decodes the aggregate in both packages
    assert type(pcodec.loads(jcodec.dumps(jagg_c))) is pagg.AggregateCommit


def _run_verdicts(ns):
    """Five aggregate heights of one set; height 3's signature forged and
    height 5's bitmap short of 2/3; one structural mismatch (height 6's
    commit offered for height 7)."""
    vset, pvs = bls_set(ns, 4, tag=b"run")
    pairs = []
    for h in range(1, 7):
        bid = block_id(ns, bytes([h]))
        agg = ns.agg.fold_commit(make_commit(ns, vset, pvs, h, 0, bid), vset, CHAIN)
        if h == 3:
            agg.agg_sig = agg.agg_sig[:-1] + bytes([agg.agg_sig[-1] ^ 1])
        if h == 5:
            two = ns.BitArray(4)
            two.set_index(0, True)
            two.set_index(2, True)
            msg = agg.sign_message(CHAIN)
            agg = ns.agg.AggregateCommit(h, 0, bid, two, ns.scheme.aggregate_signatures(
                [pvs[i].priv_key.sign(msg) for i in (0, 2)]), agg.timestamp_ns)
        pairs.append((bid, 7 if h == 6 else h, agg))
    return ns.processor.verify_commit_run(vset, CHAIN, pairs)


def test_verify_commit_run_of_aggregate_commits_gives_the_jax_verdicts():
    got = _run_verdicts(PORT)
    assert got == _run_verdicts(JAX)
    assert got == [True, True, False, True, False, False]


async def test_verify_commit_run_keeps_one_flat_batch_for_ed25519_members():
    """A run of per-vote ed25519 commits still reaches the installed batch
    hook as ONE flat batch (the card's ladder), beside no pairing."""
    seen = []

    def hook(pks, msgs, sigs):
        seen.append(len(pks))
        from tendermint_tpu_torch.crypto.ed25519_math import verify
        return [verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]

    Ed = _ed(PORT)
    pvs = sorted((ppv.MockPV(Ed.from_secret(b"flat-%d" % i)) for i in range(4)),
                 key=lambda pv: pv.get_pub_key().address())
    vset = pvalidator.ValidatorSet([pvalidator.Validator.new(pv.get_pub_key(), 10) for pv in pvs])
    pairs = []
    for h in (1, 2, 3):
        bid = block_id(PORT, bytes([h]))
        pairs.append((bid, h, make_commit(PORT, vset, pvs, h, 0, bid)))
    batch_hook.set_verifier(hook)
    assert pprocessor.verify_commit_run(vset, CHAIN, pairs) == [True] * 3
    assert seen == [12]


class _Peer:
    def __init__(self, pid):
        self.id = pid
        self.sent = []

    async def send(self, chan, msg):
        self.sent.append((chan, msg))
        return True


def _frame(ns):
    """The `agg_commit` frame each package's reactor sends for a stored
    aggregate, and what its receive path hands consensus for that frame."""
    _, _, _, _, agg = folded(ns)
    r = ns.reactor.ConsensusReactor.__new__(ns.reactor.ConsensusReactor)
    fed = []

    async def add_agg_commit_input(commit, peer_id=""):
        fed.append((commit, peer_id))

    r.cs = types.SimpleNamespace(
        config=types.SimpleNamespace(gossip_vote_batch=False, gossip_vote_summary=False,
                                     gossip_trace_context=False),
        recorder=types.SimpleNamespace(record=lambda *a, **k: None),
        add_agg_commit_input=add_agg_commit_input)
    peer = _Peer("peer-" + ns.name)
    ps = ns.reactor.PeerRoundState()
    ps.height = agg.height
    assert _run(r._send_agg_commit(peer, ps, agg)) is True
    assert _run(r._send_agg_commit(peer, ps, agg)) is False  # deduped until the resend timer
    return r, peer, ps, agg, fed


def test_agg_commit_frame_bytes_equal_jax_and_each_reads_the_others():
    jr, jpeer, jps, jagg_c, jfed = _frame(JAX)
    pr, ppeer, pps, pagg_c, pfed = _frame(PORT)
    assert ppeer.sent == jpeer.sent and len(ppeer.sent) == 1
    chan, frame = ppeer.sent[0]
    assert chan == preactor.VOTE_CHANNEL == jreactor.VOTE_CHANNEL
    # each package's receive path reads the other's frame
    pr.peer_states = {jpeer.id: pps}
    pr.wait_sync = False
    jr.peer_states = {ppeer.id: jps}
    jr.wait_sync = False
    _run(pr.receive(chan, jpeer, jpeer.sent[0][1]))
    _run(jr.receive(chan, ppeer, frame))
    assert len(pfed) == len(jfed) == 1
    assert wire(pfed[0][0]) == wire(jagg_c) and wire(jfed[0][0]) == wire(pagg_c)
    assert (pfed[0][1], jfed[0][1]) == (jpeer.id, ppeer.id)


async def test_async_lanes_pair_once_and_warm_the_memo():
    """verify_bls_aggregates gives JAX's scheme verdicts; state sync's
    pre-verify and liteserve's VerifyCache each run one pairing claim for
    an aggregate header and serve the synchronous check from the memo."""
    from tendermint_tpu_torch.crypto.batch_verifier import AsyncBatchVerifier, BatchVerifier
    from tendermint_tpu_torch.liteserve.cache import VerifyCache
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.statesync.syncer import EngineCommitPreverify

    vset, pvs, bid, _, agg = folded(PORT, n=4, height=4, tag=b"lane")
    msg = agg.sign_message(CHAIN)
    pks = [vset.validators[i].pub_key.bytes() for i in agg.signers.true_indices()]
    forged = agg.agg_sig[:-1] + bytes([agg.agg_sig[-1] ^ 1])
    items = [(pks, msg, agg.agg_sig), (pks, msg, forged), (pks[:2], msg, agg.agg_sig)]
    rec = FlightRecorder(size=64)
    av = AsyncBatchVerifier(BatchVerifier(device="cpu", min_device_batch=1 << 20, recorder=rec))
    await av.start()
    try:
        got = await av.verify_bls_aggregates(items)
        assert got == list(jscheme.batch_verify_aggregates(items)) == [True, False, False]
        assert [e["n"] for e in rec.events() if e["kind"] == "verify.bls_agg"] == [3]

        header = types.SimpleNamespace(chain_id=CHAIN, hash=lambda: b"\x07" * 32)
        sh = types.SimpleNamespace(header=header, height=4, commit=agg)
        assert await EngineCommitPreverify(av)(sh, [vset]) is None
        assert pscheme.memo_get(pks, msg, agg.agg_sig) is True
        cache = VerifyCache(capacity=4, async_verifier=av, recorder=rec)
        assert await cache.preverify()(sh, [vset]) is None
        assert await cache.preverify()(sh, [vset]) is None
        assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 1
        assert [e["agg"] for e in rec.events() if e["kind"] == "liteserve.verify"] == [True]
        vset.verify_commit(CHAIN, bid, 4, agg)
    finally:
        await av.stop()


def _lite_chain(ns):
    """Heights 1 and 9 of a uniformly BLS chain whose set loses one member
    and gains one at height 9; verify(1 -> 9) by skipping."""
    from importlib import import_module

    block = import_module(("tendermint_tpu" if ns is JAX else "tendermint_tpu_torch")
                          + ".types.block")
    old, opvs = bls_set(ns, 4, tag=b"lite")
    new_pvs = opvs[:3] + [ns.MockPV(ns.Bls.from_secret(b"lite-new"))]
    new_pvs.sort(key=lambda pv: pv.get_pub_key().address())
    new = ns.ValidatorSet([ns.Validator.new(pv.get_pub_key(), 10) for pv in new_pvs])
    out = []
    for h, vset, pvs in ((1, old, opvs), (9, new, new_pvs)):
        header = block.Header(chain_id=CHAIN, height=h, time_ns=T0 + h * 1_000_000_000,
                              validators_hash=vset.hash(), next_validators_hash=vset.hash())
        bid = ns.BlockID(hash=header.hash(), parts_header=ns.PartSetHeader(1, b"\x05" * 32))
        commit = ns.agg.fold_commit(make_commit(ns, vset, pvs, h, 0, bid), vset, CHAIN)
        out.append((block.SignedHeader(header, commit), vset))
    (trusted, tvals), (untrusted, uvals) = out
    return [outcome(lambda: ns.lite.verify(CHAIN, trusted, tvals, untrusted, uvals,
                                          3600 * 10**9, T0 + 10 * 10**9, 10 * 10**9,
                                          trust_level=lvl))
            for lvl in ((1, 3), (1, 1))]


def test_lite2_skipping_verification_over_aggregate_commits_equals_jax():
    got = _lite_chain(PORT)
    assert got == _lite_chain(JAX)
    assert got[0] == ("ok", None) and got[1][0] == "ErrNewValSetCantBeTrusted"


# ---------------------------------------------------------------------------
# in-process nets (JAX TestBlsNets)
# ---------------------------------------------------------------------------


def _genesis(pkg, pvs, chain):
    if pkg == "jax":
        from tendermint_tpu.types.params import BlockParams, ConsensusParams
        G, V = jtypes.GenesisDoc, jtypes.GenesisValidator
    else:
        from tendermint_tpu_torch.types.genesis import GenesisDoc as G, GenesisValidator as V
        from tendermint_tpu_torch.types.params import BlockParams, ConsensusParams
    return G(chain_id=chain, genesis_time_ns=T0,
             consensus_params=ConsensusParams(block=BlockParams(time_iota_ms=1)),
             validators=[V(pv.get_pub_key().address(), pv.get_pub_key(), 10,
                           pop=pv.priv_key.pop()) for pv in pvs])


def _node(pkg, home, gen, pv=None, db="memdb", fast_sync=False):
    """A node of either package as the JAX BLS nets run them (timeouts above
    a pairing, timeout_commit 0.1 s, PEX off); the port's engine on the CPU."""
    if pkg == "jax":
        from tendermint_tpu.config import test_config
        from tendermint_tpu.node import Node
    else:
        from tendermint_tpu_torch.config import test_config
        from tendermint_tpu_torch.node import Node
    cfg = test_config(home)
    cfg.rpc.laddr = ""
    cfg.base.db_backend = db
    cfg.base.fast_sync = fast_sync
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.consensus.skip_timeout_commit = False
    cfg.consensus.timeout_commit = 0.1
    cfg.consensus.timeout_propose = 2.0
    cfg.consensus.timeout_prevote = 0.5
    cfg.consensus.timeout_precommit = 0.5
    if pkg == "jax":
        return Node(cfg, gen, priv_validator=pv, db_backend=db)
    cfg.tpu.enabled = True
    return Node(cfg, gen, priv_validator=pv, db_backend=db, device="cpu")


async def _dial(node, peers):
    for p in peers:
        await node.switch.dial_peer(f"{p.node_key.id}@{p.switch.transport.listen_addr}")


async def _until(pred, timeout, what):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        assert loop.time() < deadline, what
        await asyncio.sleep(0.05)


async def _stop(nodes):
    for n in nodes:
        if n.is_running:
            await n.stop()
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)


def _check_folded(node, below, n_vals=4):
    """Every stored block commit and seen commit below `below` is an
    AggregateCommit whose bitmap holds more than 2/3 of the power."""
    for h in range(1, below):
        for c in (node.block_store.load_block_commit(h), node.block_store.load_seen_commit(h)):
            assert isinstance(c, pagg.AggregateCommit), (h, type(c))
            assert c.signers.count() * 3 > n_vals * 2


async def test_port_bls_net_commits_aggregate_and_serves_both_joiners(tmp_path, monkeypatch):
    """Four port validators, aggregation at its default: every stored commit
    below the tip folds; a late non-validator with fast sync off catches up
    through the `agg_commit` lane, and an empty one with fast sync on
    replays the aggregate heights, each commit checked by one pairing in
    the fast-sync reactor's verify_commit (as in the JAX package)."""
    _, pvs = bls_set(PORT, 4, tag=b"net")
    gen = _genesis("port", pvs, "agg-net")
    nodes = [_node("port", str(tmp_path / f"v{i}"), gen, pv) for i, pv in enumerate(pvs)]
    joiners = []
    try:
        for n in nodes:
            await n.start()
        for i, n in enumerate(nodes):
            await _dial(n, nodes[i + 1:])
        await _until(lambda: all(n.block_store.height() >= 4 for n in nodes), 120.0,
                     "the validators did not reach height 4")
        for n in nodes:
            _check_folded(n, 4)
        assert len({n.block_store.load_block(3).hash() for n in nodes}) == 1
        # the fast-sync joiner stays in fast sync (the gate the JAX rigs
        # hold), so that no slow start hands it to consensus early
        from tendermint_tpu_torch.fastsync import reactor as fs_reactor

        monkeypatch.setattr(fs_reactor, "SWITCH_TO_CONSENSUS_INTERVAL", 3600.0)
        catchup = _node("port", str(tmp_path / "catchup"), gen)
        fast = _node("port", str(tmp_path / "fast"), gen, fast_sync=True)
        joiners = [catchup, fast]
        for j in joiners:
            await j.start()
            await _dial(j, nodes)
        target = min(n.block_store.height() for n in nodes)
        await _until(lambda: all(j.block_store.height() >= target for j in joiners), 120.0,
                     "a joiner never caught up")
        for j in joiners:
            _check_folded(j, target - 1)
        kinds = [e["kind"] for e in catchup.flight_recorder.events()]
        assert "commit.agg_catchup" in kinds
        assert fast.blockchain_reactor.blocks_synced == fast.block_store.height() >= target
    finally:
        await _stop(joiners + nodes)


async def test_bls_node_restart_rebuilds_its_aggregate_last_commit(tmp_path):
    """A restarted BLS validator finds an aggregate seen commit: it checks
    the pairing, carries the AggregateLastCommit adapter and keeps
    committing, the next proposal embedding the aggregate as it is."""
    pv = ppv.MockPV(pbls.BlsPrivKey.from_secret(b"solo"))
    gen = _genesis("port", [pv], "agg-solo")
    home = str(tmp_path / "solo")
    node = _node("port", home, gen, pv, db="sqlite")
    try:
        await node.start()
        await _until(lambda: node.block_store.height() >= 2, 60.0, "no height 2")
        stopped_at = node.block_store.height()
        assert isinstance(node.block_store.load_seen_commit(stopped_at), pagg.AggregateCommit)
    finally:
        await _stop([node])
    node2 = _node("port", home, gen, pv, db="sqlite")
    try:
        await node2.start()
        assert isinstance(node2.consensus.rs.last_commit, pagg.AggregateLastCommit)
        await _until(lambda: node2.block_store.height() >= stopped_at + 1, 60.0,
                     "the restarted node did not commit")
        assert isinstance(node2.block_store.load_block_commit(stopped_at), pagg.AggregateCommit)
    finally:
        await _stop([node2])


async def test_net_of_port_and_jax_validators_folds_the_same_commits(tmp_path):
    """Validators 0 and 2 (by address) on the JAX package, 1 and 3 on the
    port, aggregation on: blocks 1-3 and their aggregate commits byte-equal
    on all four, and a late port non-validator with fast sync off, dialled
    to the JAX nodes alone, catches up on their `agg_commit` frames."""
    kinds = ("jax", "port", "jax", "port")
    _, ppvs = bls_set(PORT, 4, tag=b"mix")
    _, jpvs = bls_set(JAX, 4, tag=b"mix")
    gens = {"port": _genesis("port", ppvs, "agg-mixed"), "jax": _genesis("jax", jpvs, "agg-mixed")}
    nodes = [_node(k, str(tmp_path / f"n{i}"), gens[k], (jpvs if k == "jax" else ppvs)[i])
             for i, k in enumerate(kinds)]
    joiner = None
    try:
        for n in nodes:
            await n.start()
        for i, n in enumerate(nodes):
            await _dial(n, nodes[i + 1:])
        await _until(lambda: all(n.block_store.height() >= 4 for n in nodes), 120.0,
                     "the mixed-package net did not reach height 4")
        for h in (1, 2, 3):
            raw = {(pcodec if k == "port" else jcodec).dumps(n.block_store.load_block(h))
                   for n, k in zip(nodes, kinds)}
            assert len(raw) == 1, f"height {h} differs"
            commits = {n.block_store.load_block_commit(h).encode() for n in nodes}
            assert len(commits) == 1
        for n, k in zip(nodes, kinds):
            assert type(n.block_store.load_block_commit(2)).__name__ == "AggregateCommit"
        joiner = _node("port", str(tmp_path / "joiner"), gens["port"])
        await joiner.start()
        await _dial(joiner, [nodes[0], nodes[2]])
        target = min(n.block_store.height() for n in nodes)
        await _until(lambda: joiner.block_store.height() >= target, 120.0,
                     "the port joiner never caught up on the JAX nodes' frames")
        assert isinstance(joiner.block_store.load_block_commit(2), pagg.AggregateCommit)
        assert "commit.agg_catchup" in [e["kind"] for e in joiner.flight_recorder.events()]
    finally:
        await _stop(nodes + ([joiner] if joiner is not None else []))
