"""The port's chain types (tendermint_tpu_torch: SimpleProof, TxProof,
ConsensusParams, PartSet, Block, DuplicateVoteEvidence, GenesisDoc, State,
median_time) against the JAX package's, on the same inputs.

`build_chain(ns)` builds one small chain in either package from the same
secrets and a numpy seed: 7 validators at power 10, blocks 1..HEIGHTS of
a few txs each, every block from height 2 on carrying the previous
height's commit, and a change set at height ROTATE_AT - 2 replacing the 2
oldest validators (set B from ROTATE_AT on).  ed25519 signing is
deterministic, so the two chains must be equal byte for byte.  The store
and fast-sync tests import it.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

import tendermint_tpu.crypto.merkle as jmerkle
import tendermint_tpu.state as jstate
import tendermint_tpu.state.state as jstate_mod
import tendermint_tpu.types as jtypes
import tendermint_tpu.types.evidence as jevidence
import tendermint_tpu.types.genesis as jgenesis
import tendermint_tpu.types.params as jparams
import tendermint_tpu.types.part_set as jpart_set
import tendermint_tpu.types.tx as jtx
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu.libs import kvstore as jkvstore
from tendermint_tpu.libs import watchdog as jwatchdog
from tendermint_tpu.lite2 import store as jlite_store
from tendermint_tpu.state import store as jstate_store
from tendermint_tpu.store import block_store as jblock_store
from tendermint_tpu_torch import fastsync as pfastsync
from tendermint_tpu_torch import state as pstate
from tendermint_tpu_torch.crypto import merkle as pmerkle
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding import codec as pcodec
from tendermint_tpu_torch.libs import kvstore as pkvstore
from tendermint_tpu_torch.libs import watchdog as pwatchdog
from tendermint_tpu_torch.lite2 import store as plite_store
from tendermint_tpu_torch.state import store as pstate_store
from tendermint_tpu_torch.store import block_store as pblock_store
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import evidence as pevidence
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import params as pparams
from tendermint_tpu_torch.types import part_set as ppart_set
from tendermint_tpu_torch.types import tx as ptx
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import vote as pvote
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE

import tendermint_tpu.fastsync.processor as jprocessor
import tendermint_tpu.fastsync.scheduler as jscheduler

CHAIN = "chain-parity"
SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC
N_VALS, ROTATE, HEIGHTS, ROTATE_AT, TXS = 7, 2, 6, 4, 3
PART = 256  # small parts: every block spans several

PORT = types.SimpleNamespace(
    name="port", PrivKey=Ed25519PrivKey, codec=pcodec, merkle=pmerkle, params=pparams,
    tx=ptx, evidence=pevidence, part_set=ppart_set, genesis=pgenesis, state=pstate,
    state_store=pstate_store, block_store=pblock_store, kvstore=pkvstore,
    watchdog=pwatchdog, lite_store=plite_store, Processor=pfastsync.Processor,
    Scheduler=pfastsync.Scheduler, verify_commit_run=pfastsync.verify_commit_run,
    Block=pblock.Block, BlockID=pblock.BlockID, PartSetHeader=pblock.PartSetHeader,
    Header=pblock.Header, Commit=pblock.Commit, CommitSig=pblock.CommitSig,
    SignedHeader=pblock.SignedHeader, Vote=pvote.Vote, Validator=pvalidator.Validator,
    ValidatorSet=pvalidator.ValidatorSet,
)
JAX = types.SimpleNamespace(
    name="jax", PrivKey=JPrivKey, codec=jcodec, merkle=jmerkle, params=jparams,
    tx=jtx, evidence=jevidence, part_set=jpart_set, genesis=jgenesis, state=jstate,
    state_store=jstate_store, block_store=jblock_store, kvstore=jkvstore,
    watchdog=jwatchdog, lite_store=jlite_store, Processor=jprocessor.Processor,
    Scheduler=jscheduler.Scheduler, verify_commit_run=jprocessor.verify_commit_run,
    Block=jtypes.Block, BlockID=jtypes.BlockID, PartSetHeader=jtypes.PartSetHeader,
    Header=jtypes.Header, Commit=jtypes.Commit, CommitSig=jtypes.CommitSig,
    SignedHeader=jtypes.SignedHeader, Vote=jtypes.Vote, Validator=jtypes.Validator,
    ValidatorSet=jtypes.ValidatorSet,
)


def outcome(fn):
    """(exception type name and message) or ("ok", result)."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the parity is over any exception
        return type(e).__name__, str(e)


def sign_commit(ns, vset, key_of, height, bid, ts):
    sigs = [ns.CommitSig(2, v.address, ts + i, b"") for i, v in enumerate(vset.validators)]
    unsigned = ns.Commit(height, 0, bid, sigs)
    return ns.Commit(height, 0, bid, [
        ns.CommitSig(2, cs.validator_address, cs.timestamp_ns,
                     key_of[cs.validator_address].sign(unsigned.vote_sign_bytes(CHAIN, i)))
        for i, cs in enumerate(sigs)])


def next_state(ns, state, block_id, block, changes=None):
    """update_state without an app: changes land two heights on."""
    nxt = state.next_validators.copy()
    changed = state.last_height_validators_changed
    if changes:
        nxt.update_with_change_set(changes)
        changed = block.height + 2
    nxt.increment_proposer_priority(1)
    return dataclasses.replace(
        state, last_block_height=block.height, last_block_id=block_id,
        last_block_time_ns=block.time_ns, next_validators=nxt,
        validators=state.next_validators.copy(), last_validators=state.validators.copy(),
        last_height_validators_changed=changed,
        last_results_hash=ns.tx.results_hash([ns.tx.ABCIResult(0, b"") for _ in block.txs]),
        app_hash=b"")


def build_chain(ns, heights=HEIGHTS, seed=7):
    """One package's chain: {"gen", "states" (state after h, 0 = genesis),
    "blocks", "parts", "ids", "commits", "keys", "key_of"}."""
    keys = [ns.PrivKey.from_secret(f"chain-{i}".encode()) for i in range(N_VALS + ROTATE)]
    key_of = {k.pub_key().address(): k for k in keys}
    gen = ns.genesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        ns.genesis.GenesisValidator(k.pub_key().address(), k.pub_key(), 10, f"v{i}")
        for i, k in enumerate(keys[:N_VALS])])
    state = ns.state.make_genesis_state(gen)
    changes = ([ns.Validator.new(k.pub_key(), 0) for k in keys[:ROTATE]]
               + [ns.Validator.new(k.pub_key(), 10) for k in keys[N_VALS:]])
    rng = np.random.default_rng(seed)
    out = {"gen": gen, "states": {0: state}, "blocks": {}, "parts": {}, "ids": {},
           "commits": {}, "keys": keys, "key_of": key_of}
    last_commit = None
    for h in range(1, heights + 1):
        txs = [row.tobytes() for row in rng.integers(0, 256, (TXS, 40 + h), dtype=np.uint8)]
        block = state.make_block(h, txs, last_commit, [], state.validators.get_proposer().address)
        parts = block.make_part_set(PART)
        bid = ns.BlockID(block.hash(), parts.header())
        commit = sign_commit(ns, state.validators, key_of, h, bid, block.time_ns + SEC)
        state = next_state(ns, state, bid, block, changes if h == ROTATE_AT - 2 else None)
        out["states"][h], out["blocks"][h], out["parts"][h] = state, block, parts
        out["ids"][h], out["commits"][h] = bid, commit
        last_commit = commit
    return out


_chains = {}


def chain(ns):
    if ns.name not in _chains:
        _chains[ns.name] = build_chain(ns)
    return _chains[ns.name]


def evidence_pair(ns):
    """A DuplicateVoteEvidence of validator 0 at height 3 (two precommits
    for different blocks, both signed)."""
    c = chain(ns)
    v = c["states"][2].validators.validators[0]
    key = c["key_of"][v.address]
    votes = []
    for tag in (b"\x01", b"\x02"):
        bid = ns.BlockID(tag * 32, ns.PartSetHeader(1, tag * 32))
        vote = ns.Vote(PRECOMMIT_TYPE, 3, 0, bid, T0 + 3 * SEC, v.address, 0)
        vote.signature = key.sign(vote.sign_bytes(CHAIN))
        votes.append(vote)
    return ns.evidence.DuplicateVoteEvidence.from_votes(v.pub_key, *votes)


# ---------------------------------------------------------------------------
# merkle proofs, txs, params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_simple_proofs_match_jax(n):
    items = [bytes([i]) * (i + 1) for i in range(n)]
    root, proofs = pmerkle.proofs_from_byte_slices(items)
    jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
    assert root == jroot == pmerkle.hash_from_byte_slices(items)
    assert [p.to_dict() for p in proofs] == [p.to_dict() for p in jproofs]
    for i, (p, item) in enumerate(zip(proofs, items)):
        assert p.compute_root() == root and p.verify(root, item)
        assert not p.verify(root, item + b"!")
        assert pmerkle.SimpleProof.from_dict(jproofs[i].to_dict()).verify(root, item)
        bad = dataclasses.replace(p, index=n)
        assert bad.verify(root, item) == dataclasses.replace(jproofs[i], index=n).verify(root, item)


def test_tx_proofs_and_results_hash_match_jax():
    txs = [bytes([i]) * (10 + i) for i in range(6)]
    assert ptx.txs_hash(txs) == jtx.txs_hash(txs)
    for i in range(len(txs)):
        p, j = ptx.tx_proof(txs, i), jtx.tx_proof(txs, i)
        assert p.to_dict() == j.to_dict()
        p.validate(ptx.txs_hash(txs))
        assert ptx.TxProof.from_dict(j.to_dict()) == p
    p = ptx.tx_proof(txs, 2)
    cases = [
        (lambda m, q: q.validate(b"\x00" * 32)),
        (lambda m, q: dataclasses.replace(q, data=b"other").validate(q.root_hash)),
        (lambda m, q: dataclasses.replace(
            q, proof=dataclasses.replace(q.proof, total=0)).validate(q.root_hash)),
    ]
    j = jtx.tx_proof(txs, 2)
    for case in cases:
        assert outcome(lambda: case(ptx, p)) == outcome(lambda: case(jtx, j))
    results = [ptx.ABCIResult(i % 3, bytes([i])) for i in range(5)]
    jresults = [jtx.ABCIResult(i % 3, bytes([i])) for i in range(5)]
    assert ptx.results_hash(results) == jtx.results_hash(jresults)


def test_consensus_params_match_jax():
    variants = [{}, {"block": {"max_bytes": 1000, "max_gas": 77}},
                {"evidence": {"max_age_num_blocks": 5}}, {"validator": {"pub_key_types": ["ed25519"]}}]
    for changes in variants:
        p = pparams.ConsensusParams().update(changes)
        j = jparams.ConsensusParams().update(changes)
        assert p.hash() == j.hash() and p.to_dict() == j.to_dict()
        assert pparams.ConsensusParams.from_dict(j.to_dict()) == p
    bad = [{"block": {"max_bytes": 0}}, {"block": {"max_gas": -2}},
           {"validator": {"pub_key_types": ["rsa"]}}]
    for changes in bad:
        assert outcome(lambda: pparams.ConsensusParams().update(changes).validate()) == outcome(
            lambda: jparams.ConsensusParams().update(changes).validate())
    assert pparams.max_evidence_per_block(22020096) == jparams.max_evidence_per_block(22020096)
    assert (pparams.MAX_SIGNATURE_SIZE, pparams.MAX_VOTES_COUNT, pparams.BLOCK_PART_SIZE_BYTES) == (
        jparams.MAX_SIGNATURE_SIZE, jparams.MAX_VOTES_COUNT, jparams.BLOCK_PART_SIZE_BYTES)


# ---------------------------------------------------------------------------
# blocks and part sets
# ---------------------------------------------------------------------------


def test_blocks_hash_and_serialize_as_jax():
    ours, theirs = chain(PORT), chain(JAX)
    for h in range(1, HEIGHTS + 1):
        a, b = ours["blocks"][h], theirs["blocks"][h]
        assert a.hash() == b.hash()
        assert a.serialize() == b.serialize()
        assert a.header.to_dict() == b.header.to_dict()
        assert ours["commits"][h].hash() == theirs["commits"][h].hash()
        assert pblock.Block.deserialize(b.serialize()).hash() == b.hash()
        assert jtypes.Block.deserialize(a.serialize()).hash() == a.hash()
        assert a.size() == b.size()


def test_part_sets_match_jax():
    ours, theirs = chain(PORT), chain(JAX)
    for h in (1, HEIGHTS):
        a, b = ours["parts"][h], theirs["parts"][h]
        assert a.total == b.total > 1 and a.header() == pblock.PartSetHeader(b.total, b.hash())
        assert [p.to_dict() for p in a.parts] == [p.to_dict() for p in b.parts]
        assert a.assemble() == b.assemble() == ours["blocks"][h].serialize()
        # gossip: an empty set from the header takes the parts back
        fresh = ppart_set.PartSet.from_header(a.header())
        assert [fresh.add_part(p) for p in a.parts] == [True] * a.total
        assert fresh.is_complete() and fresh.assemble() == a.assemble()
        assert fresh.add_part(a.parts[0]) is False
    a, b = ours["parts"][1], theirs["parts"][1]
    forged = ppart_set.Part(0, b"x" + a.parts[0].bytes[1:], a.parts[0].proof)
    jforged = jpart_set.Part(0, b"x" + b.parts[0].bytes[1:], b.parts[0].proof)
    assert outcome(lambda: ppart_set.PartSet.from_header(a.header()).add_part(forged)) == outcome(
        lambda: jpart_set.PartSet.from_header(b.header()).add_part(jforged))
    assert outcome(lambda: ppart_set.PartSet.from_header(a.header()).add_part(
        dataclasses.replace(forged, index=a.total))) == outcome(
        lambda: jpart_set.PartSet.from_header(b.header()).add_part(
            dataclasses.replace(jforged, index=b.total)))


def test_block_validate_basic_errors_match_jax():
    def cases(ns, c):
        blk = c["blocks"][3]
        hdr = blk.header

        def with_header(**kw):
            return ns.Block(dataclasses.replace(hdr, **kw), blk.txs, blk.evidence, blk.last_commit)

        return [
            lambda: blk.validate_basic(),
            lambda: with_header(height=0).validate_basic(),
            lambda: with_header(chain_id="x" * 51).validate_basic(),
            lambda: with_header(data_hash=b"\x01" * 32).validate_basic(),
            lambda: with_header(last_commit_hash=b"\x01" * 32).validate_basic(),
            lambda: with_header(evidence_hash=b"\x01" * 31).validate_basic(),
            lambda: with_header(proposer_address=b"\x01" * 3).validate_basic(),
            lambda: ns.Block(hdr, blk.txs, blk.evidence, None).validate_basic(),
            lambda: ns.Block(hdr, blk.txs + [b"extra"], blk.evidence, blk.last_commit).validate_basic(),
        ]

    for ours, theirs in zip(cases(PORT, chain(PORT)), cases(JAX, chain(JAX))):
        assert outcome(ours) == outcome(theirs)


def test_aggregate_commit_dicts_raise_type_error():
    """A block dict whose last commit is an aggregate (BLS) commit decodes
    to the same AggregateCommit bytes in both packages, and median_time
    reads its one timestamp (or fails as the JAX package fails)."""
    got = {}
    for ns in (PORT, JAX):
        d = chain(ns)["blocks"][2].to_dict()
        lc = d["last_commit"]
        d["last_commit"] = {"height": lc["height"], "round": lc["round"],
                            "block_id": lc["block_id"], "signers": b"\x00\x01\x0f",
                            "agg_sig": b"\x00" * 96, "timestamp_ns": 77}
        blk = ns.Block.from_dict(d)
        vals = chain(ns)["states"][1].validators
        median_time = (pstate if ns is PORT else jstate_mod).median_time
        got[ns is PORT] = (type(blk.last_commit).__name__, blk.last_commit.encode(),
                           blk.last_commit.hash(), median_time(blk.last_commit, vals),
                           outcome(lambda: median_time(object(), vals)))
    assert got[True] == got[False]
    assert got[True][0] == "AggregateCommit" and got[True][3] == 77


# ---------------------------------------------------------------------------
# evidence, genesis, state
# ---------------------------------------------------------------------------


def test_evidence_bytes_and_hash_match_jax():
    a, b = evidence_pair(PORT), evidence_pair(JAX)
    assert a.bytes() == b.bytes() and a.hash() == b.hash()
    assert pevidence.evidence_list_hash([a]) == jevidence.evidence_list_hash([b])
    assert pevidence.evidence_list_hash([]) == jevidence.evidence_list_hash([])
    a.validate_basic()
    a.verify(CHAIN, a.pub_key)
    assert pevidence.DuplicateVoteEvidence.from_dict(b.to_dict()) == a
    # a block that carries it: the header's evidence hash and the bytes agree
    blocks = []
    for ns, ev in ((PORT, a), (JAX, b)):
        st = chain(ns)["states"][3]
        blk = st.make_block(4, [b"tx"], chain(ns)["commits"][3], [ev],
                            st.validators.get_proposer().address)
        blk.validate_basic()
        blocks.append(blk)
    assert blocks[0].hash() == blocks[1].hash() and blocks[0].serialize() == blocks[1].serialize()
    assert pblock.Block.deserialize(blocks[1].serialize()).evidence == [a]


def test_genesis_json_matches_jax():
    p, j = chain(PORT)["gen"], chain(JAX)["gen"]
    assert p.to_json() == j.to_json()
    assert pgenesis.GenesisDoc.from_json(j.to_json()).to_json() == p.to_json()
    assert p.validator_hash() == j.validator_hash()
    doc = json.loads(p.to_json())
    for mutate in (lambda d: d.update(chain_id=""), lambda d: d.update(chain_id="c" * 51),
                   lambda d: d["validators"][0].update(power="0"),
                   lambda d: d["validators"][0].update(address="00" * 20)):
        d = json.loads(json.dumps(doc))
        mutate(d)
        ours = outcome(lambda: pgenesis.GenesisDoc.from_json(json.dumps(d)))
        theirs = outcome(lambda: jgenesis.GenesisDoc.from_json(json.dumps(d)))
        assert ours[0] == theirs[0] != "ok"
        assert ours[1].replace("tendermint_tpu_torch", "tendermint_tpu") == theirs[1] \
            or "Validator" in ours[1]


def test_states_and_median_time_match_jax():
    ours, theirs = chain(PORT), chain(JAX)
    for h in range(0, HEIGHTS + 1):
        a, b = ours["states"][h], theirs["states"][h]
        assert a.bytes() == b.bytes()
        assert pstate.State.from_dict(b.to_dict()).bytes() == a.bytes()
        assert a.copy().bytes() == a.bytes()
        if h:
            assert pstate.median_time(ours["commits"][h], ours["states"][h - 1].validators) \
                == jstate_mod.median_time(theirs["commits"][h], theirs["states"][h - 1].validators)
    # make_block at every height, the rotation included
    for h in range(1, HEIGHTS + 1):
        assert ours["blocks"][h].header.proposer_address == theirs["blocks"][h].header.proposer_address
        assert ours["blocks"][h].time_ns == theirs["blocks"][h].time_ns
    assert ours["states"][HEIGHTS].validators.hash() != ours["states"][1].validators.hash()
