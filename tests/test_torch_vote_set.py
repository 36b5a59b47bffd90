"""The port's VoteSet, Vote, DuplicateVoteEvidence and BitArray
(tendermint_tpu_torch/types/vote_set.py and friends) against the JAX
package's, on the same votes.

Every scenario of the JAX package's TestVoteSet and TestVoteSetScaleQueries
(tests/test_types.py) runs on both packages with the same keys, signatures
and operations; return values, exception types and messages, maj23, the bit
arrays, the evidence and make_commit's signatures must be identical.
"""

import types

import numpy as np
import pytest

import tendermint_tpu.types as jtypes
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.libs.bitarray import BitArray as JBitArray
from tendermint_tpu.types.vote import VoteError as JVoteError
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.block import BlockID, Commit, PartSetHeader
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import ErrVoteConflictingVotes, Vote, VoteError
from tendermint_tpu_torch.types.vote_set import VoteSet

CHAIN_ID = "test-chain"

PORT = types.SimpleNamespace(
    name="port", PrivKey=Ed25519PrivKey, Validator=Validator, ValidatorSet=ValidatorSet,
    Vote=Vote, VoteSet=VoteSet, BlockID=BlockID, PartSetHeader=PartSetHeader,
    BitArray=BitArray, VoteError=VoteError, Conflict=ErrVoteConflictingVotes,
    Evidence=DuplicateVoteEvidence, Commit=Commit,
)
JAX = types.SimpleNamespace(
    name="jax", PrivKey=JPrivKey, Validator=jtypes.Validator, ValidatorSet=jtypes.ValidatorSet,
    Vote=jtypes.Vote, VoteSet=jtypes.VoteSet, BlockID=jtypes.BlockID,
    PartSetHeader=jtypes.PartSetHeader, BitArray=JBitArray, VoteError=JVoteError,
    Conflict=jtypes.ErrVoteConflictingVotes, Evidence=jtypes.DuplicateVoteEvidence,
    Commit=jtypes.Commit,
)
PREVOTE, PRECOMMIT = canonical.PREVOTE_TYPE, canonical.PRECOMMIT_TYPE


class Net:
    """One package's view of n validators made from fixed secrets (the
    same keys, addresses and signatures in both packages)."""

    def __init__(self, pkg, n, power=10, seed=0):
        self.pkg = pkg
        rng = np.random.default_rng(seed)
        secrets = [f"vs-{seed}-{i}-{int(rng.integers(1 << 30))}".encode() for i in range(n)]
        keys = [pkg.PrivKey.from_secret(s) for s in secrets]
        self.vset = pkg.ValidatorSet([pkg.Validator.new(k.pub_key(), power) for k in keys])
        by_addr = {k.pub_key().address(): k for k in keys}
        self.keys = [by_addr[v.address] for v in self.vset.validators]  # set order

    def block_id(self, seed=b"\x01"):
        return self.pkg.BlockID(seed * 32, self.pkg.PartSetHeader(1, seed * 32))

    def vote(self, i, vote_type, height, round_, block_id, ts=None):
        v = self.vset.validators[i]
        vote = self.pkg.Vote(type=vote_type, height=height, round=round_, block_id=block_id,
                             timestamp_ns=1_000_000 + i if ts is None else ts,
                             validator_address=v.address, validator_index=i)
        vote.signature = self.keys[i].sign(vote.sign_bytes(CHAIN_ID))
        return vote

    def vote_set(self, vote_type=PREVOTE, height=1, round_=0):
        return self.pkg.VoteSet(CHAIN_ID, height, round_, vote_type, self.vset)


def outcome(fn):
    """("ok", value) or (exception type name, message)."""
    try:
        return "ok", fn()
    except Exception as e:  # the outcome under comparison is the exception itself
        return type(e).__name__, str(e)


def bid_tuple(bid):
    return None if bid is None else (bid.hash, bid.parts_header.total, bid.parts_header.hash)


def bits(ba):
    return None if ba is None else (ba.bits, ba.true_indices())


def state(vs):
    """Everything observable about a VoteSet, package-neutral."""
    return {
        "maj23": bid_tuple(vs.maj23),
        "two_thirds": (vs.has_two_thirds_majority(), vs.has_two_thirds_any(), vs.has_all(),
                       vs.is_commit(), bid_tuple(vs.two_thirds_majority()[0])),
        "sum": vs.sum,
        "bits": bits(vs.bit_array()),
        "by_block": sorted(
            (k, b.sum, b.peer_maj23, b.bit_array.true_indices()) for k, b in vs.votes_by_block.items()
        ),
        "votes": [None if v is None else (v.validator_index, bid_tuple(v.block_id), v.signature)
                  for v in vs.votes],
    }


def vote_key(v):
    return (v.validator_index, bid_tuple(v.block_id), v.signature, v.timestamp_ns)


# ---------------------------------------------------------------------------
# TestVoteSet scenarios: each returns a list of observations
# ---------------------------------------------------------------------------


def sc_majority_tracking(pkg):
    net = Net(pkg, 10, power=1)
    vs = net.vote_set()
    bid = net.block_id()
    obs = [outcome(lambda i=i: vs.add_vote(net.vote(i, PREVOTE, 1, 0, bid))) for i in range(6)]
    obs.append(state(vs))
    obs.append(outcome(lambda: vs.add_vote(net.vote(6, PREVOTE, 1, 0, bid))))
    obs.append(state(vs))
    return obs


def sc_nil_votes_count_toward_any_not_block(pkg):
    net = Net(pkg, 4, power=1)
    vs = net.vote_set()
    obs = [outcome(lambda i=i: vs.add_vote(net.vote(i, PREVOTE, 1, 0, pkg.BlockID())))
           for i in range(3)]
    return obs + [state(vs), vs.maj23 is not None and vs.maj23.is_zero()]


def sc_duplicate_vote_returns_false(pkg):
    net = Net(pkg, 4)
    vs = net.vote_set()
    v = net.vote(0, PREVOTE, 1, 0, net.block_id())
    return [outcome(lambda: vs.add_vote(v)), outcome(lambda: vs.add_vote(v)), state(vs)]


def sc_wrong_height_round_type_rejected(pkg):
    net = Net(pkg, 4)
    vs = net.vote_set()
    bid = net.block_id()
    return [outcome(lambda: vs.add_vote(net.vote(0, t, h, r, bid)))
            for t, h, r in ((PREVOTE, 2, 0), (PREVOTE, 1, 1), (PRECOMMIT, 1, 0))]


def sc_invalid_signature_rejected(pkg):
    net = Net(pkg, 4)
    vs = net.vote_set()
    v = net.vote(0, PREVOTE, 1, 0, net.block_id())
    v.signature = b"\x01" * 64
    # verify=False takes the batch verifier's word: the same vote is added
    return [outcome(lambda: vs.add_vote(v)), state(vs),
            outcome(lambda: vs.add_vote(v, verify=False)), state(vs)]


def sc_conflicting_votes_produce_evidence(pkg):
    net = Net(pkg, 4)
    vs = net.vote_set()
    first = net.vote(0, PREVOTE, 1, 0, net.block_id(b"\x02"))
    second = net.vote(0, PREVOTE, 1, 0, net.block_id(b"\x01"))
    obs = [outcome(lambda: vs.add_vote(first))]
    with pytest.raises(pkg.Conflict) as ei:
        vs.add_vote(second)
    ev = ei.value.evidence
    assert isinstance(ev, pkg.Evidence)
    pub = net.keys[0].pub_key()
    obs += [str(ei.value), vote_key(ev.vote_a), vote_key(ev.vote_b), ev.height(), ev.time_ns(),
            ev.address(), ev.pub_key.bytes(), outcome(lambda: ev.verify(CHAIN_ID, pub)),
            outcome(ev.validate_basic), repr(ev), state(vs)]
    # evidence against another validator's key fails the same way
    obs.append(outcome(lambda: ev.verify(CHAIN_ID, net.keys[1].pub_key())))
    return obs


def sc_peer_maj23_allows_conflict_tracking(pkg):
    net = Net(pkg, 4, power=1)
    vs = net.vote_set()
    bid_a, bid_b = net.block_id(b"\x0a"), net.block_id(b"\x0b")
    obs = [outcome(lambda: vs.set_peer_maj23("peer1", bid_b)),
           outcome(lambda: vs.add_vote(net.vote(0, PREVOTE, 1, 0, bid_a))),
           outcome(lambda: vs.add_vote(net.vote(0, PREVOTE, 1, 0, bid_b)))]
    obs += [bits(vs.bit_array_by_block_id(bid_b)), bits(vs.bit_array_by_block_id(bid_a)), state(vs)]
    # the same claim again is a no-op; a different one from that peer raises
    obs.append(outcome(lambda: vs.set_peer_maj23("peer1", bid_b)))
    obs.append(outcome(lambda: vs.set_peer_maj23("peer1", bid_a)))
    # once bid_b gathers +2/3 its votes replace the canonical ones
    for i in (1, 2, 3):
        obs.append(outcome(lambda i=i: vs.add_vote(net.vote(i, PREVOTE, 1, 0, bid_b))))
    return obs + [state(vs)]


def sc_make_commit(pkg):
    net = Net(pkg, 4)
    bid = net.block_id()
    vs = net.vote_set(PRECOMMIT, 2, 1)
    obs = [outcome(lambda: vs.make_commit())]  # no +2/3 yet
    for i in range(4):
        vs.add_vote(net.vote(i, PRECOMMIT, 2, 1, bid))
    commit = vs.make_commit()
    obs += [commit.height, commit.round, bid_tuple(commit.block_id),
            [(cs.block_id_flag, cs.validator_address, cs.timestamp_ns, cs.signature)
             for cs in commit.signatures],
            outcome(lambda: net.vset.verify_commit(CHAIN_ID, bid, 2, commit))]
    prevotes = net.vote_set(PREVOTE, 2, 1)
    obs.append(outcome(lambda: prevotes.make_commit()))
    return obs


def sc_structural_errors(pkg):
    net = Net(pkg, 4)
    vs = net.vote_set()
    bid = net.block_id()
    obs = [outcome(lambda: vs.add_vote(None))]
    bad_index = net.vote(0, PREVOTE, 1, 0, bid)
    bad_index.validator_index = 9
    neg_index = net.vote(0, PREVOTE, 1, 0, bid)
    neg_index.validator_index = -1
    wrong_addr = net.vote(0, PREVOTE, 1, 0, bid)
    wrong_addr.validator_address = net.vset.validators[1].address
    no_addr = net.vote(0, PREVOTE, 1, 0, bid)
    no_addr.validator_address = b""
    for v in (bad_index, neg_index, wrong_addr, no_addr):
        obs.append(outcome(lambda v=v: vs.add_vote(v)))
    # the same validator and block, another signature: non-deterministic
    vs.add_vote(net.vote(0, PREVOTE, 1, 0, bid))
    other = net.vote(0, PREVOTE, 1, 0, bid, ts=42)
    obs.append(outcome(lambda: vs.add_vote(other)))
    obs.append(outcome(lambda: vs.get_by_address(b"\x00" * 20)))
    obs.append(vote_key(vs.get_by_address(net.vset.validators[0].address)))
    obs += [vs.get_by_index(-1), vs.get_by_index(7), vs.size(), repr(vs)]
    obs.append(outcome(lambda: pkg.VoteSet(CHAIN_ID, 0, 0, PREVOTE, net.vset)))
    return obs


def sc_vote_methods(pkg):
    net = Net(pkg, 4)
    v = net.vote(2, PRECOMMIT, 3, 1, net.block_id())
    nil = net.vote(1, PRECOMMIT, 3, 1, pkg.BlockID())
    obs = [str(v), str(nil), v.is_nil(), nil.is_nil(), vote_key(v.copy()),
           outcome(v.validate_basic), outcome(nil.validate_basic),
           outcome(lambda: v.verify(CHAIN_ID, net.keys[2].pub_key())),
           outcome(lambda: v.verify(CHAIN_ID, net.keys[1].pub_key()))]
    bad = v.copy()
    bad.signature = bytes(64)
    obs.append(outcome(lambda: bad.verify(CHAIN_ID, net.keys[2].pub_key())))
    for field, value in (("type", 7), ("height", -1), ("round", -1), ("validator_index", -1),
                         ("validator_address", b"\x01"), ("signature", b""),
                         ("signature", b"\x01" * 97),
                         ("block_id", pkg.BlockID(b"\x01" * 32))):
        w = v.copy()
        setattr(w, field, value)
        obs.append(outcome(w.validate_basic))
    return obs


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_majority_tracking, sc_nil_votes_count_toward_any_not_block, sc_duplicate_vote_returns_false,
    sc_wrong_height_round_type_rejected, sc_invalid_signature_rejected,
    sc_conflicting_votes_produce_evidence, sc_peer_maj23_allows_conflict_tracking,
    sc_make_commit, sc_structural_errors, sc_vote_methods,
)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_vote_set_matches_jax(name):
    ours, theirs = SCENARIOS[name](PORT), SCENARIOS[name](JAX)
    assert ours == theirs


def test_majority_expectations():
    """The JAX test's own expectations, on the port."""
    net = Net(PORT, 10, power=1)
    vs = net.vote_set()
    bid = net.block_id()
    for i in range(6):
        assert vs.add_vote(net.vote(i, PREVOTE, 1, 0, bid))
    assert not vs.has_two_thirds_majority() and not vs.has_two_thirds_any()
    assert vs.add_vote(net.vote(6, PREVOTE, 1, 0, bid))
    maj, ok = vs.two_thirds_majority()
    assert ok and maj == bid and vs.has_two_thirds_any()


def test_conflict_evidence_verifies_on_the_port():
    net = Net(PORT, 4)
    vs = net.vote_set()
    vs.add_vote(net.vote(0, PREVOTE, 1, 0, net.block_id(b"\x01")))
    with pytest.raises(ErrVoteConflictingVotes) as ei:
        vs.add_vote(net.vote(0, PREVOTE, 1, 0, net.block_id(b"\x02")))
    ev = ei.value.evidence
    assert ev.vote_a.block_id.key() < ev.vote_b.block_id.key()
    ev.verify(CHAIN_ID, net.keys[0].pub_key())


# ---------------------------------------------------------------------------
# TestVoteSetScaleQueries at 128 validators, both packages
# ---------------------------------------------------------------------------

N = 128


def scale_set(pkg, held):
    net = Net(pkg, N, power=1, seed=1)
    vs = net.vote_set()
    bid = net.block_id()
    for i in range(held):
        vs.add_vote(net.vote(i, PREVOTE, 1, 0, bid), verify=False)
    return vs


def sq_missing_votes_sparse(pkg):
    vs = scale_set(pkg, held=3)
    return [[v.validator_index for v in vs.missing_votes(arg)]
            for arg in (pkg.BitArray(N), None, vs.bit_array())]


def sq_missing_votes_dense_one_lacking(pkg):
    vs = scale_set(pkg, held=N - 1)
    peer_bits = vs.bit_array()
    peer_bits.set_index(peer_bits.true_indices()[7], False)
    return [v.validator_index for v in vs.missing_votes(peer_bits)]


def sq_bits_we_lack_clamps_and_diffs(pkg):
    vs = scale_set(pkg, held=3)
    return [bits(vs.bits_we_lack(pkg.BitArray.from_indices(N, range(N)))),
            bits(vs.bits_we_lack(pkg.BitArray.from_indices(N * 4, range(N * 4)))),
            bits(vs.bits_we_lack(None))]


def sq_select_votes_skips_unheld_and_clamps(pkg):
    vs = scale_set(pkg, held=3)
    held = vs.bit_array().true_indices()
    unheld = next(i for i in range(N) if i not in held)
    return [[v.validator_index for v in vs.select_votes(b)] for b in (
        pkg.BitArray.from_indices(N * 2, range(N * 2)),
        pkg.BitArray.from_indices(N, [held[0], unheld]),
        None,
    )]


QUERIES = {f.__name__[3:]: f for f in (
    sq_missing_votes_sparse, sq_missing_votes_dense_one_lacking,
    sq_bits_we_lack_clamps_and_diffs, sq_select_votes_skips_unheld_and_clamps,
)}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_scale_queries_match_jax(name):
    ours, theirs = QUERIES[name](PORT), QUERIES[name](JAX)
    assert ours == theirs


def test_scale_query_expectations():
    """The JAX test's own expectations, on the port."""
    vs = scale_set(PORT, held=3)
    assert len(vs.missing_votes(BitArray(N))) == 3
    assert vs.missing_votes(vs.bit_array()) == []
    lack = vs.bits_we_lack(BitArray.from_indices(N, range(N)))
    assert lack.count() == N - 3
    assert vs.bits_we_lack(BitArray.from_indices(N * 4, range(N * 4))).bits == N
    assert vs.bits_we_lack(None).count() == 0
    assert vs.select_votes(None) == []


# ---------------------------------------------------------------------------
# BitArray, whole
# ---------------------------------------------------------------------------


def bitarray_ops(pkg):
    rng = np.random.default_rng(7)
    a = pkg.BitArray.from_indices(37, rng.choice(37, 12, replace=False).tolist())
    b = pkg.BitArray.from_indices(29, rng.choice(29, 20, replace=False).tolist())
    out = [str(x) for x in (a.or_(b), a.and_(b), a.not_(), a.sub(b), b.sub(a))]
    out += [a.count(), a.is_empty(), a.is_full(), pkg.BitArray(3).not_().is_full(),
            pkg.BitArray(0).is_full(), a.get_index(-1), a.get_index(99), a.set_index(99, True),
            a.true_indices(), a.to_bytes(), repr(b), len(a), a == a.copy(), a == b,
            pkg.BitArray.from_bytes(a.to_bytes()) == a, a.as_numpy().tolist()]
    import random

    out.append(a.pick_random(random.Random(3)))
    out.append(pkg.BitArray(5).pick_random())
    out.append(outcome(lambda: pkg.BitArray(-1)))
    return out


def test_bitarray_matches_jax():
    assert bitarray_ops(PORT) == bitarray_ops(JAX)
