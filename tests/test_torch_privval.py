"""The port's signers (tendermint_tpu_torch: types/proposal.py,
types/priv_validator.py, privval/file.py, the key and vote helpers) against
the JAX package's.

ed25519 signing is deterministic, so the same sign sequence gives the same
signatures, and a FilePV's key and state files are the same JSON byte for
byte; each package loads and continues the other's files.  Tolerance: exact
everywhere.
"""

import json
import types

import pytest

import tendermint_tpu.crypto.keys as jkeys
import tendermint_tpu.encoding.codec as jcodec
import tendermint_tpu.privval.file as jfile
import tendermint_tpu.types as jtypes
import tendermint_tpu.types.canonical as jcanonical
import tendermint_tpu.types.priv_validator as jpv
from tendermint_tpu_torch import privval as pprivval
from tendermint_tpu_torch.crypto import keys as pkeys
from tendermint_tpu_torch.encoding import codec as pcodec
from tendermint_tpu_torch.privval import file as pfile
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import canonical as pcanonical
from tendermint_tpu_torch.types import priv_validator as ppv
from tendermint_tpu_torch.types import proposal as pproposal
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import vote as pvote

from test_torch_chain_types import outcome

PORT = types.SimpleNamespace(
    name="port", keys=pkeys, codec=pcodec, file=pfile, pv=ppv, canonical=pcanonical,
    Proposal=pproposal.Proposal, Vote=pvote.Vote, BlockID=pblock.BlockID,
    PartSetHeader=pblock.PartSetHeader, Validator=pvalidator.Validator,
    ValidatorSet=pvalidator.ValidatorSet)
JAX = types.SimpleNamespace(
    name="jax", keys=jkeys, codec=jcodec, file=jfile, pv=jpv, canonical=jcanonical,
    Proposal=jtypes.Proposal, Vote=jtypes.Vote, BlockID=jtypes.BlockID,
    PartSetHeader=jtypes.PartSetHeader, Validator=jtypes.Validator,
    ValidatorSet=jtypes.ValidatorSet)
BOTH = (PORT, JAX)
CHAIN = "privval-parity"
SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC


def bid(ns, tag=b"\x01"):
    return ns.BlockID(tag * 32, ns.PartSetHeader(3, tag[::-1] * 32))


def proposal(ns, h=5, r=0, pol=-1, ts=T0, tag=b"\x01"):
    return ns.Proposal(height=h, round=r, pol_round=pol, block_id=bid(ns, tag), timestamp_ns=ts)


def vote(ns, key, t, h, r, ts, tag=b"\x01", idx=2):
    block_id = bid(ns, tag) if tag else ns.BlockID()
    return ns.Vote(t, h, r, block_id, ts, key.pub_key().address(), idx)


# ---------------------------------------------------------------------------
# Proposal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,r,pol,ts", [(1, 0, -1, 0), (5, 2, 1, T0), (1 << 40, 7, 6, T0 + 5)])
def test_proposal_bytes_match_jax(h, r, pol, ts):
    ours, theirs = proposal(PORT, h, r, pol, ts), proposal(JAX, h, r, pol, ts)
    assert ours.sign_bytes(CHAIN) == theirs.sign_bytes(CHAIN)
    assert pcanonical.PROPOSAL_TYPE == jcanonical.PROPOSAL_TYPE == 0x20
    ours.signature = theirs.signature = b"\x05" * 64
    assert ours.to_dict() == theirs.to_dict()
    raw = pcodec.dumps(ours)
    assert raw == jcodec.dumps(theirs)
    assert pcodec.loads(jcodec.dumps(theirs)) == ours
    assert jcodec.loads(raw).to_dict() == theirs.to_dict()
    assert str(ours) == str(theirs)


def test_proposal_validate_basic_matches_jax():
    def cases(ns):
        good = proposal(ns)
        good.signature = b"\x01" * 64
        out = [good]
        for field, value in (("type", 1), ("height", -1), ("round", -1), ("pol_round", -2),
                             ("block_id", ns.BlockID()), ("signature", b""),
                             ("signature", b"\x01" * 65)):
            p = proposal(ns)
            p.signature = b"\x01" * 64
            setattr(p, field, value)
            out.append(p)
        return [outcome(p.validate_basic) for p in out]

    assert cases(PORT) == cases(JAX)


# ---------------------------------------------------------------------------
# keys and votes
# ---------------------------------------------------------------------------


def test_key_helpers_match_jax():
    for secret in (b"a", b"b"):
        ours, theirs = pkeys.Ed25519PrivKey.from_secret(secret), jkeys.Ed25519PrivKey.from_secret(
            secret)
        assert ours.to_dict() == theirs.to_dict()
        assert pkeys.privkey_from_dict(theirs.to_dict()).bytes() == theirs.bytes()
        assert pkeys.Ed25519PrivKey.from_dict(ours.to_dict()).bytes() == ours.bytes()
        # the golang seed||pub layout
        assert pkeys.Ed25519PrivKey(ours.bytes() + ours.pub_key().bytes()).bytes() == ours.bytes()
    assert pkeys.generate_priv_key().pub_key().address() != pkeys.generate_priv_key(
        "ed25519").pub_key().address()
    # sr25519 and secp256k1 load and generate as in the JAX package
    for t in ("tendermint/PrivKeySr25519", "tendermint/PrivKeySecp256k1"):
        raw = b"\x07" * 32
        ours, theirs = pkeys.privkey_from_dict({"type": t, "value": raw}), jkeys.privkey_from_dict(
            {"type": t, "value": raw})
        assert ours.to_dict() == theirs.to_dict()
        assert ours.pub_key().to_dict() == theirs.pub_key().to_dict()
    for t in ("sr25519", "secp256k1"):
        key = pkeys.generate_priv_key(t)
        assert type(key).__name__ == type(jkeys.generate_priv_key(t)).__name__
        assert jkeys.privkey_from_dict(key.to_dict()).pub_key().to_dict() == key.pub_key().to_dict()
    # bls12381 loads and generates as in the JAX package
    raw = b"\x00" * 32
    ours = pkeys.privkey_from_dict({"type": "tendermint/PrivKeyBLS12381", "value": raw})
    theirs = jkeys.privkey_from_dict({"type": "tendermint/PrivKeyBLS12381", "value": raw})
    assert ours.to_dict() == theirs.to_dict()
    assert ours.pub_key().to_dict() == theirs.pub_key().to_dict()
    assert ours.pop() == theirs.pop()
    key = pkeys.generate_priv_key("bls12381")
    assert type(key).__name__ == type(jkeys.generate_priv_key("bls12381")).__name__
    assert jkeys.privkey_from_dict(key.to_dict()).pub_key().to_dict() == key.pub_key().to_dict()
    assert outcome(lambda: pkeys.privkey_from_dict({"type": "x", "value": b""})) == outcome(
        lambda: jkeys.privkey_from_dict({"type": "x", "value": b""}))
    assert outcome(lambda: pkeys.generate_priv_key("rsa")) == outcome(
        lambda: jkeys.generate_priv_key("rsa"))


def test_vote_wire_and_key_routed_sign_bytes_match_jax():
    for t in (1, 2):
        votes = []
        for ns in BOTH:
            key = ns.keys.Ed25519PrivKey.from_secret(b"voter")
            v = vote(ns, key, t, 9, 1, T0 + 7, tag=b"\x03" if t == 1 else b"")
            sb = v.sign_bytes_for_key(CHAIN, key.pub_key())
            assert sb == v.sign_bytes(CHAIN)
            v.signature = key.sign(sb)
            votes.append((sb, v.wire(), v.wire() is v.wire()))
        assert votes[0] == votes[1]
        assert pcodec.loads(votes[1][1]).to_dict() == jcodec.loads(votes[0][1]).to_dict()

    class BlsKey:
        TYPE = "tendermint/PubKeyBLS12381"

    # a BLS key routes to the timestamp-free domain in both packages
    sbs = [vote(ns, ns.keys.Ed25519PrivKey.from_secret(b"x"), 2, 1, 0, T0 + k)
           .sign_bytes_for_key(CHAIN, BlsKey()) for ns in BOTH for k in (0, 9)]
    assert len(set(sbs)) == 1 and sbs[0] != vote(
        PORT, pkeys.Ed25519PrivKey.from_secret(b"x"), 2, 1, 0, T0).sign_bytes(CHAIN)


# ---------------------------------------------------------------------------
# FilePV
# ---------------------------------------------------------------------------


def new_file_pv(ns, d, secret=b"file-pv"):
    priv = ns.keys.Ed25519PrivKey.from_secret(secret)
    key = ns.file.FilePVKey(priv.pub_key().address(), priv.pub_key(), priv,
                            str(d / "priv_validator_key.json"))
    pv = ns.file.FilePV(key, ns.file.FilePVLastSignState(
        file_path=str(d / "priv_validator_state.json")))
    pv.save()
    return pv


def sign_steps(ns, pv):
    """A validator's sign sequence over three heights: proposal, prevote,
    precommit; a nil round; the same-HRS re-sign, the timestamp-only
    re-sign; every conflicting and regressing request.  Returns each step's
    outcome and the state file after it."""
    key = pv.key.priv_key
    steps = []

    def run(name, fn):
        steps.append((name, outcome(fn), open(pv.last_sign_state.file_path).read()))

    def sign_vote(v):
        def fn():
            pv.sign_vote(CHAIN, v)
            return v.signature, v.timestamp_ns
        return fn

    def sign_prop(p):
        def fn():
            pv.sign_proposal(CHAIN, p)
            return p.signature, p.timestamp_ns
        return fn

    run("proposal 1/0", sign_prop(proposal(ns, 1, 0, ts=T0)))
    run("prevote 1/0", sign_vote(vote(ns, key, 1, 1, 0, T0 + 1)))
    run("prevote 1/0 again", sign_vote(vote(ns, key, 1, 1, 0, T0 + 1)))
    run("prevote 1/0 later ts", sign_vote(vote(ns, key, 1, 1, 0, T0 + 99)))
    run("prevote 1/0 other block", sign_vote(vote(ns, key, 1, 1, 0, T0 + 1, tag=b"\x02")))
    run("precommit 1/0", sign_vote(vote(ns, key, 2, 1, 0, T0 + 2)))
    run("proposal 1/0 regress", sign_prop(proposal(ns, 1, 0, ts=T0)))
    run("prevote 1/1 nil", sign_vote(vote(ns, key, 1, 1, 1, T0 + 3, tag=b"")))
    run("precommit 1/1 nil", sign_vote(vote(ns, key, 2, 1, 1, T0 + 4, tag=b"")))
    run("proposal 2/0", sign_prop(proposal(ns, 2, 0, ts=T0 + 5)))
    run("proposal 2/0 later ts", sign_prop(proposal(ns, 2, 0, ts=T0 + 50)))
    run("proposal 2/0 other block", sign_prop(proposal(ns, 2, 0, ts=T0 + 5, tag=b"\x09")))
    run("prevote 1/1 regress", sign_vote(vote(ns, key, 1, 1, 1, T0 + 3, tag=b"")))
    run("unknown vote type", sign_vote(vote(ns, key, 7, 3, 0, T0)))
    run("challenge", lambda: pv.sign_challenge(b"\x11" * 32))
    run("short challenge", lambda: pv.sign_challenge(b"\x11"))
    return steps


def test_file_pv_files_and_signatures_match_jax(tmp_path):
    out = {}
    for ns in BOTH:
        d = tmp_path / ns.name
        d.mkdir()
        pv = new_file_pv(ns, d)
        steps = sign_steps(ns, pv)
        out[ns.name] = (steps, (d / "priv_validator_key.json").read_bytes(), repr(pv),
                        pv.address())
    assert out["port"] == out["jax"]
    names = {name: res[0] for name, res, _ in out["port"][0]}
    assert names["prevote 1/0 other block"] == "DoubleSignError"
    assert names["proposal 2/0 other block"] == "DoubleSignError"
    assert names["proposal 1/0 regress"] == names["prevote 1/1 regress"] == "DoubleSignError"
    steps = dict((name, res) for name, res, _ in out["port"][0])
    # the timestamp-only re-sign releases the signature and timestamp signed first
    assert steps["prevote 1/0 later ts"] == steps["prevote 1/0"]
    assert steps["proposal 2/0 later ts"] == steps["proposal 2/0"]
    key = json.loads(out["port"][1])
    assert set(key) == {"address", "pub_key", "priv_key"}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_each_package_loads_and_continues_the_others_files(tmp_path, writer, reader):
    new_file_pv(writer, tmp_path)
    w = writer.file.FilePV.load(str(tmp_path / "priv_validator_key.json"),
                                str(tmp_path / "priv_validator_state.json"))
    k = w.key.priv_key
    v = vote(writer, k, 1, 4, 0, T0)
    w.sign_vote(CHAIN, v)
    pv = reader.file.FilePV.load(str(tmp_path / "priv_validator_key.json"),
                                 str(tmp_path / "priv_validator_state.json"))
    assert pv.address() == w.address() and pv.get_pub_key().bytes() == w.get_pub_key().bytes()
    again = vote(reader, pv.key.priv_key, 1, 4, 0, T0 + 30)
    pv.sign_vote(CHAIN, again)  # the same HRS, a later timestamp: the first signature
    assert (again.signature, again.timestamp_ns) == (v.signature, T0)
    with pytest.raises(reader.file.DoubleSignError, match="height regression"):
        pv.sign_vote(CHAIN, vote(reader, pv.key.priv_key, 1, 3, 0, T0))
    pv.sign_vote(CHAIN, vote(reader, pv.key.priv_key, 2, 4, 0, T0 + 1))
    back = writer.file.FilePV.load(str(tmp_path / "priv_validator_key.json"),
                                   str(tmp_path / "priv_validator_state.json"))
    assert (back.last_sign_state.height, back.last_sign_state.step) == (4, 3)


def test_load_or_generate_and_missing_state(tmp_path):
    for ns in BOTH:
        d = tmp_path / ns.name
        pv = ns.file.FilePV.load_or_generate(str(d / "k.json"), str(d / "s.json"))
        again = ns.file.FilePV.load_or_generate(str(d / "k.json"), str(d / "s.json"))
        assert again.address() == pv.address()
        (d / "s.json").unlink()
        fresh = ns.file.FilePV.load(str(d / "k.json"), str(d / "s.json"))
        assert fresh.last_sign_state.height == 0
    assert pprivval.FilePV is pfile.FilePV and pprivval.DoubleSignError is pfile.DoubleSignError


def test_failed_state_save_rolls_back(tmp_path):
    """The last-sign state is persisted before a signature escapes; a failed
    save refuses the sign and leaves the HRS signable."""
    out = {}
    for ns in BOTH:
        d = tmp_path / ns.name
        d.mkdir()
        pv = new_file_pv(ns, d)
        lss = pv.last_sign_state
        real = lss.file_path
        lss.file_path = str(d / "missing-dir" / "x" / "\x00bad")
        first = outcome(lambda: pv.sign_vote(CHAIN, vote(ns, pv.key.priv_key, 1, 2, 0, T0)))
        lss.file_path = real
        v = vote(ns, pv.key.priv_key, 1, 2, 0, T0)
        pv.sign_vote(CHAIN, v)
        out[ns.name] = (first[0], (lss.height, lss.round, lss.step), v.signature)
    assert out["port"] == out["jax"]
    assert out["port"][0] != "ok"


# ---------------------------------------------------------------------------
# MockPV, RotatingPV
# ---------------------------------------------------------------------------


def test_mock_pv_matches_jax():
    out = {}
    for ns in BOTH:
        key = ns.keys.Ed25519PrivKey.from_secret(b"mock")
        res = []
        for kw in ({}, {"break_vote_signing": True, "break_proposal_signing": True}):
            pv = ns.pv.MockPV(key, **kw)
            v, p = vote(ns, key, 2, 3, 0, T0), proposal(ns, 3)
            pv.sign_vote(CHAIN, v)
            pv.sign_proposal(CHAIN, p)
            res.append((v.signature, p.signature, pv.sign_challenge(b"\x02" * 32), repr(pv),
                        pv.address()))
        res.append(ns.pv.challenge_sign_bytes(b"\x03" * 32))
        res.append(outcome(lambda: ns.pv.challenge_sign_bytes(b"\x03")))
        out[ns.name] = res
    assert out["port"] == out["jax"]
    assert isinstance(ppv.MockPV().get_pub_key(), pkeys.Ed25519PubKey)


def test_rotating_pv_observe_validators_matches_jax():
    out = {}
    for ns in BOTH:
        a, b, c = (ns.keys.Ed25519PrivKey.from_secret(s) for s in (b"ka", b"kb", b"kc"))
        pa, pb = ns.pv.MockPV(a), ns.pv.MockPV(b)
        rot = ns.pv.RotatingPV(pa, pb)
        seen = [rot.address()]
        for members in ((c,), (b, c), (a,), (c,)):
            rot.observe_validators(ns.ValidatorSet([ns.Validator.new(k.pub_key(), 10)
                                                    for k in members]))
            v = vote(ns, a, 1, 2, 0, T0)
            rot.sign_vote(CHAIN, v)
            seen.append((rot.address(), rot.active is pb, v.signature))
        seen.append(outcome(lambda: ns.pv.RotatingPV()))
        out[ns.name] = seen
    assert out["port"] == out["jax"]
    assert [s[1] for s in out["port"][1:5]] == [False, True, False, False]
