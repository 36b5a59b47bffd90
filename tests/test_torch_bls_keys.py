"""BLS12-381 keys through the port's plumbing (crypto/keys.py's dispatch,
privval/file.py, cli.py, types/genesis.py, types/vote.py, types/block.py,
types/validator.py, state/execution.py, apps/staking.py, node.py and
consensus/state.py) against the JAX package's, on keys made from seeded
secrets and timestamps drawn with seeded numpy.  Tolerance exact: bytes,
hashes and verdicts equal, raised errors equal by type and message.

- Keys: dicts, codec bytes, the key dispatch for every key type, `FilePV`
  files both ways with a vote signed and re-signed, `init --key-type
  bls12381`'s genesis proof of possession.
- Sets with BLS members: genesis PoP enforcement, BLS vote sign-bytes, a
  mixed ed25519 + BLS commit's verdicts and messages through
  `verify_commit`, `verify_future_commit` and `verify_commit_trusting`
  (tampered BLS signatures included), its ed25519 members as one flat
  batch on the port's CPU engine, `update_state` with BLS updates, the
  staking app's `_address_of` and a BLS `rotate`.
- Aggregate commits: `check_ported` accepts a uniformly BLS genesis with
  `[consensus] bls_aggregate_commits` on, with the batched BLS fold and
  with the mesh, and the consensus fold point returns the JAX
  package's AggregateCommit byte for byte exactly where its `fold_commit`
  folds (tests/test_torch_agg_commit.py holds the rest).
- Nets of two port and two JAX validators: a mixed set commits per-vote
  commits with aggregation on (JAX
  TestBlsNets.test_mixed_set_net_commits_without_aggregation), and a
  uniformly BLS set does with it off; blocks byte-equal on all four, and
  each port node's `bls_tier` gauge reads 1 (the C tier).
"""

import asyncio
import dataclasses
import json
import re
import types

import numpy as np
import pytest

import tendermint_tpu.abci.types as jabci
import tendermint_tpu.crypto.bls.keys as jbls
import tendermint_tpu.crypto.bls.scheme as jscheme
import tendermint_tpu.crypto.keys as jkeys
import tendermint_tpu.state.execution as jexecution
import tendermint_tpu.state.state as jstate
import tendermint_tpu.types as jtypes
import tendermint_tpu.types.agg_commit as jagg
from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu.privval import file as jfile
from tendermint_tpu_torch import cli as pcli
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.abci import types as pabci
from tendermint_tpu_torch.config import Config
from tendermint_tpu_torch.consensus import state as pcs
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto import keys as pkeys
from tendermint_tpu_torch.crypto.bls import keys as pbls
from tendermint_tpu_torch.encoding import codec as pcodec
from tendermint_tpu_torch.libs.tracing import FlightRecorder
from tendermint_tpu_torch.privval import file as pfile
from tendermint_tpu_torch.state import execution as pexecution
from tendermint_tpu_torch.state import state as pstate
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import vote as pvote

from test_torch_apps import JAX as AJAX
from test_torch_apps import PORT as APORT
from test_torch_apps import Run, addr, key
from test_torch_chain_types import outcome

CHAIN = "bls-keys-parity"
T0 = 1_700_000_000_000_000_000
SEED = 1920


@dataclasses.dataclass
class _Ns:
    name: str
    keys: object
    Bls: object
    Ed: object
    Commit: object
    CommitSig: object
    BlockID: object
    PartSetHeader: object
    Vote: object
    Validator: object
    ValidatorSet: object
    GenesisDoc: object
    GenesisValidator: object
    execution: object
    state: object
    abci: object
    codec: object
    FilePV: object


PORT = _Ns("port", pkeys, pbls.BlsPrivKey, pkeys.Ed25519PrivKey, pblock.Commit, pblock.CommitSig,
           pblock.BlockID, pblock.PartSetHeader, pvote.Vote, pvalidator.Validator,
           pvalidator.ValidatorSet, pgenesis.GenesisDoc, pgenesis.GenesisValidator, pexecution,
           pstate, pabci, pcodec, pfile.FilePV)
JAX = _Ns("jax", jkeys, jbls.BlsPrivKey, jkeys.Ed25519PrivKey, jtypes.Commit, jtypes.CommitSig,
          jtypes.BlockID, jtypes.PartSetHeader, jtypes.Vote, jtypes.Validator,
          jtypes.ValidatorSet, jtypes.GenesisDoc, jtypes.GenesisValidator, jexecution, jstate,
          jabci, jcodec, jfile.FilePV)


def both(fn):
    """fn(ns) in JAX then the port; asserts equal and returns the port's."""
    theirs, ours = fn(JAX), fn(PORT)
    assert ours == theirs
    return ours


def secrets(n, tag):
    r = np.random.default_rng(SEED + tag)
    return [bytes(r.integers(0, 256, 32, dtype=np.uint8)) for _ in range(n)]


@pytest.fixture(autouse=True)
def _no_hooks_left():
    yield
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def test_key_dicts_and_codec_bytes_equal_jax():
    for ikm in secrets(3, 1):
        jk, pk = jbls.BlsPrivKey(ikm), pbls.BlsPrivKey(ikm)
        assert pk.to_dict() == jk.to_dict() and pk.pub_key().to_dict() == jk.pub_key().to_dict()
        assert pk.pub_key().address() == jk.pub_key().address()
        assert pcodec.dumps(pk) == jcodec.dumps(jk)
        assert pcodec.dumps(pk.pub_key()) == jcodec.dumps(jk.pub_key())
        assert pcodec.loads(jcodec.dumps(jk.pub_key())) == pk.pub_key()
        assert pkeys.privkey_from_dict(jk.to_dict()).bytes() == pk.bytes()
        assert jkeys.pubkey_from_dict(pk.pub_key().to_dict()) == jk.pub_key()
        assert (pk.sign(b"m"), pk.pop()) == (jk.sign(b"m"), jk.pop())
    for d in ({"type": "tendermint/PubKeyBLS12381", "value": b"\x00" * 47},
              {"type": "tendermint/PrivKeyBLS12381", "value": b""}):
        load = "pubkey_from_dict" if "Pub" in d["type"] else "privkey_from_dict"
        assert outcome(lambda: getattr(pkeys, load)(d)) == outcome(
            lambda: getattr(jkeys, load)(d))


def test_generate_priv_key_for_every_key_type_equals_jax():
    assert tuple(pkeys.KEY_TYPES) == tuple(jkeys.KEY_TYPES)
    for kt in pkeys.KEY_TYPES:
        priv = pkeys.generate_priv_key(kt)
        assert type(priv).__name__ == type(jkeys.generate_priv_key(kt)).__name__
        theirs = jkeys.privkey_from_dict(priv.to_dict())
        assert theirs.pub_key().to_dict() == priv.pub_key().to_dict()
        assert jkeys.pubkey_from_dict(priv.pub_key().to_dict()).verify(b"m", priv.sign(b"m"))
    assert outcome(lambda: pkeys.generate_priv_key("rsa4096")) == outcome(
        lambda: jkeys.generate_priv_key("rsa4096"))


def test_filepv_files_round_trip_and_resign_as_jax(tmp_path):
    """A port bls12381 FilePV's files load in the JAX package and back; a
    precommit signed by each gives the same signature and state file, and a
    same-HRS re-sign with another timestamp returns the same signature (the
    BLS domain has no timestamp)."""
    kf, sf = str(tmp_path / "key.json"), str(tmp_path / "state.json")
    pv = pfile.FilePV.generate(kf, sf, "bls12381")
    pv.save()
    raw_key, raw_state = open(kf, "rb").read(), open(sf, "rb").read()
    out = {}
    for ns in (JAX, PORT):
        open(kf, "wb").write(raw_key)
        open(sf, "wb").write(raw_state)
        loaded = ns.FilePV.load(kf, sf)
        assert loaded.address() == pv.address()
        bid = ns.BlockID(b"\x05" * 32, ns.PartSetHeader(1, b"\x50" * 32))
        sigs = []
        for ts in (T0, T0 + 7):
            vote = ns.Vote(2, 1, 0, bid, ts, pv.address(), 0)
            loaded.sign_vote(CHAIN, vote)
            sigs.append(vote.signature)
            assert loaded.get_pub_key().verify(
                vote.sign_bytes_for_key(CHAIN, loaded.get_pub_key()), vote.signature)
        out[ns.name] = (sigs, open(sf, "rb").read(), open(kf, "rb").read())
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == out["port"][0][1] and out["port"][2] == raw_key


def test_init_writes_the_proof_of_possession_and_the_home_is_refused(tmp_path):
    """`init --key-type bls12381` writes a genesis whose one validator
    carries a PoP the JAX package verifies; the home is uniformly BLS, and
    the port accepts it with aggregation on (its default) and off."""
    home = str(tmp_path / "home")
    parsed = pcli.build_parser().parse_args(
        ["--home", home, "init", "--chain-id", "bls-init", "--key-type", "bls12381"])
    assert parsed.fn(parsed) == 0
    doc = json.load(open(f"{home}/config/genesis.json"))
    jgen = jtypes.GenesisDoc.from_file(f"{home}/config/genesis.json")
    jgen.validate_and_complete()
    v = jgen.validators[0]
    assert v.pop and jscheme.pop_verify(v.pub_key.bytes(), v.pop)
    assert doc["validators"][0]["pub_key"]["type"] == "tendermint/PubKeyBLS12381"
    cfg = Config(home=home)
    gen = pgenesis.GenesisDoc.from_file(cfg.genesis_file())
    assert cfg.consensus.bls_aggregate_commits and pgenesis.GenesisDoc.from_file(
        cfg.genesis_file()).validator_set().size() == 1
    pnode.check_ported(cfg)
    cfg.consensus.bls_aggregate_commits = False
    pnode.check_ported(cfg)


def test_check_ported_refuses_only_a_uniformly_bls_genesis_with_aggregation_on(tmp_path):
    """A uniformly BLS, a mixed and an empty genesis all construct a port
    node with aggregation on, and so does each with the batched BLS fold
    (`tpu.bls_jax_aggregation`, ported since ROADMAP 2.1) and with the
    verify mesh on (`tpu.mesh = "on"`, the last refusal, lifted with
    ROADMAP 2.2)."""
    bls = [pbls.BlsPrivKey.from_secret(b"cp-%d" % i) for i in range(2)]
    ed = pkeys.Ed25519PrivKey.from_secret(b"cp-ed")
    gv = pgenesis.GenesisValidator
    uniform = pgenesis.GenesisDoc("cp", validators=[gv(b"", k.pub_key(), 10, pop=k.pop())
                                                    for k in bls])
    mixed = pgenesis.GenesisDoc("cp", validators=uniform.validators + [gv(b"", ed.pub_key(), 10)])
    empty = pgenesis.GenesisDoc("cp", validators=[])
    cfg = Config(home="/nonexistent")
    assert cfg.consensus.bls_aggregate_commits
    pnode.check_ported(cfg)
    for i, doc in enumerate((uniform, mixed, empty)):
        node = pnode.Node(Config(home=str(tmp_path / str(i))), doc, db_backend="memdb",
                          device="cpu")
        assert node.config.consensus.bls_aggregate_commits
    for i, doc in enumerate((uniform, mixed, empty)):
        c = Config(home=str(tmp_path / f"fold{i}"))
        c.tpu.bls_jax_aggregation = True
        pnode.check_ported(c)
        assert pnode.Node(c, doc, db_backend="memdb", device="cpu").config.tpu.bls_jax_aggregation
    c = Config(home=str(tmp_path / "mesh"))
    c.tpu.mesh = "on"
    pnode.check_ported(c)
    assert pnode.Node(c, uniform, db_backend="memdb", device="cpu").config.tpu.mesh == "on"


# ---------------------------------------------------------------------------
# sets with BLS members
# ---------------------------------------------------------------------------


def test_genesis_proof_of_possession_enforced_with_jax_messages():
    def case(ns):
        k, other = ns.Bls.from_secret(b"gen-0"), ns.Bls.from_secret(b"gen-1")
        ed = ns.Ed.from_secret(b"gen-ed")
        gv = ns.GenesisValidator
        docs = [
            [gv(b"", k.pub_key(), 10, pop=k.pop()), gv(b"", ed.pub_key(), 10)],
            [gv(b"", k.pub_key(), 10)],
            [gv(b"", k.pub_key(), 10, pop=other.pop())],
            [gv(b"", other.pub_key(), 10, pop=other.pop()),
             gv(b"", k.pub_key(), 10, pop=b"\x01" * 96)],
            [gv(b"", ed.pub_key(), 10)],
        ]
        out = []
        for vals in docs:
            doc = ns.GenesisDoc(chain_id="bls-chain", genesis_time_ns=T0, validators=vals)
            out.append(outcome(doc.validate_and_complete))
        good = ns.GenesisDoc(chain_id="bls-chain", genesis_time_ns=T0, validators=docs[0])
        good.validate_and_complete()
        out.append(good.to_json())
        out.append(ns.GenesisDoc.from_json(good.to_json()).validators[0].pop)
        return out

    out = both(case)
    assert out[0] == out[4] == ("ok", None)
    assert [o[0] for o in out[1:4]] == ["ValueError"] * 3
    assert "no proof of possession" in out[1][1] and "invalid BLS proof" in out[2][1]


def test_bls_vote_sign_bytes_equal_jax():
    k, ed = pbls.BlsPrivKey.from_secret(b"sb"), pkeys.Ed25519PrivKey.from_secret(b"sb-ed")

    def case(ns):
        bid = ns.BlockID(b"\x05" * 32, ns.PartSetHeader(3, b"\x50" * 32))
        bk = ns.keys.pubkey_from_dict(k.pub_key().to_dict())
        ek = ns.keys.pubkey_from_dict(ed.pub_key().to_dict())
        out = []
        for vtype, b in ((1, bid), (2, bid), (2, ns.BlockID())):
            votes = [ns.Vote(vtype, 4, 1, b, ts, b"\x01" * 20, 2) for ts in (T0, T0 + 9)]
            out.append([(v.bls_sign_bytes(CHAIN), v.sign_bytes_for_key(CHAIN, bk),
                         v.sign_bytes_for_key(CHAIN, ek), v.sign_bytes(CHAIN)) for v in votes])
        commit = ns.Commit(4, 1, bid, [ns.CommitSig(2, b"\x01" * 20, T0, b""),
                                       ns.CommitSig(3, b"\x02" * 20, T0 + 5, b"")])
        out.append([commit.vote_sign_bytes(CHAIN, i, pub_key=pk)
                    for i in (0, 1) for pk in (bk, ek, None)])
        return out

    out = both(case)
    for pair in out[:3]:
        # the BLS bytes carry no timestamp; every other key's do
        assert pair[0][0] == pair[1][0] == pair[0][1] == pair[1][1]
        assert pair[0][2] == pair[0][3] != pair[1][2] and pair[0][1] != pair[0][2]
    assert out[3][0] != out[3][1] == out[3][2]


def _mixed(ns, n_ed=4, n_bls=3, power=10):
    """(set, {address: priv}) of ed25519 and BLS keys from seeded secrets."""
    privs = ([ns.Ed.from_secret(b"mx-ed-%d" % i) for i in range(n_ed)]
             + [ns.Bls.from_secret(b"mx-bls-%d" % i) for i in range(n_bls)])
    vset = ns.ValidatorSet([ns.Validator.new(p.pub_key(), power + i)
                            for i, p in enumerate(privs)])
    return vset, {p.pub_key().address(): p for p in privs}


def _bid(ns):
    return ns.BlockID(b"\x11" * 32, ns.PartSetHeader(2, b"\x22" * 32))


def _commit(ns, vset, privs, height=5, tamper=None, nil=(), absent=()):
    """Each member signs its slot (its key's sign-bytes) with seeded
    timestamps; `tamper(i, pub_key, sig)` may change a signature."""
    offs = np.random.default_rng(SEED + height).integers(0, 5_000, vset.size())
    sigs = []
    for i, v in enumerate(vset.validators):
        if i in absent:
            sigs.append(ns.CommitSig.absent())
        else:
            sigs.append(ns.CommitSig(3 if i in nil else 2, v.address, T0 + int(offs[i]) * 1_000_000,
                                     b""))
    unsigned = ns.Commit(height, 0, _bid(ns), sigs)
    out = []
    for i, (cs, v) in enumerate(zip(sigs, vset.validators)):
        if cs.is_absent():
            out.append(cs)
            continue
        sig = privs[v.address].sign(unsigned.vote_sign_bytes(CHAIN, i, pub_key=v.pub_key))
        if tamper is not None:
            sig = tamper(i, v.pub_key, sig)
        out.append(ns.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns, sig))
    return ns.Commit(height, 0, _bid(ns), out)


def _tampers():
    def bls_only(fn):
        return lambda i, pk, sig: fn(sig) if "BLS" in type(pk).TYPE else sig

    return {
        "none": None,
        "bls bit flip": bls_only(lambda s: s[:-1] + bytes([s[-1] ^ 1])),
        "bls infinity": bls_only(lambda s: bytes([0xC0]) + b"\x00" * 95),
        "bls short": bls_only(lambda s: s[:95]),
        # the first BLS member signed the timestamped layout instead
        "bls another message": "timestamped",
        "ed25519 bit flip": lambda i, pk, sig: (bytes([sig[0] ^ 1]) + sig[1:]
                                                if "Ed25519" in type(pk).TYPE else sig),
    }


def _commit_for(ns, vset, privs, name):
    tamper = _tampers()[name]
    if tamper == "timestamped":
        commit = _commit(ns, vset, privs)
        i = next(j for j, v in enumerate(vset.validators) if "BLS" in type(v.pub_key).TYPE)
        cs = commit.signatures[i]
        v = ns.Vote(2, commit.height, 0, _bid(ns), cs.timestamp_ns, cs.validator_address, i)
        commit.signatures[i] = ns.CommitSig(2, cs.validator_address, cs.timestamp_ns,
                                            privs[cs.validator_address].sign(v.sign_bytes(CHAIN)))
        return commit
    return _commit(ns, vset, privs, tamper=tamper)


@pytest.mark.parametrize("tamper", list(_tampers()))
def test_mixed_commit_verdicts_and_errors_equal_jax(tamper):
    """A mixed ed25519 + BLS per-vote commit on the host hooks of both
    packages: `verify_commit`, `verify_future_commit` (lite2's adjacent
    check against the old set) and `verify_commit_trusting` give the same
    pass or the same error, `wrong signature (#i)` at the first bad index."""
    def case(ns):
        vset, privs = _mixed(ns)
        commit = _commit_for(ns, vset, privs, tamper)
        bigger, _ = _mixed(ns, n_bls=4)
        return [outcome(lambda: vset.verify_commit(CHAIN, _bid(ns), 5, commit)),
                outcome(lambda: vset.verify_future_commit(vset, CHAIN, _bid(ns), 5, commit)),
                outcome(lambda: vset.verify_commit_trusting(CHAIN, _bid(ns), 5, commit, 1, 3)),
                outcome(lambda: bigger.verify_commit_trusting(CHAIN, _bid(ns), 5, commit, 1, 3)),
                outcome(lambda: vset.verify_commit(CHAIN, _bid(ns), 6, commit))]

    out = both(case)
    if tamper == "none":
        assert out[:4] == [("ok", None)] * 4
    else:
        assert out[0][0] == "ValueError" and out[0][1].startswith("wrong signature (#")
    assert out[4][0] == "ValueError"


def test_mixed_commit_sends_its_ed25519_members_as_one_flat_batch():
    """On the port's CPU engine (BatchVerifier and TableCache installed as
    the hooks), a mixed commit declines the indexed path and sends its
    ed25519 members alone to one flat batch (the plain ladder here, the
    ladder kernel on the card); the BLS members verify on the host.  A bad
    BLS signature raises JAX's error at its index."""
    vset, privs = _mixed(PORT)
    jset, jprivs = _mixed(JAX)
    rec = FlightRecorder(size=256)
    bv = bvm.BatchVerifier(device="cpu", recorder=rec).install()
    bvm.TableCache(bv, tabulated=False).install()
    commit = _commit(PORT, vset, privs)
    vset.verify_commit(CHAIN, _bid(pblock), 5, commit)
    n_ed = sum("Ed25519" in type(v.pub_key).TYPE for v in vset.validators)
    assert [(e["path"], e["n"]) for e in rec.events(kinds=["verify.dispatch"])] == [
        ("device", n_ed)]
    seq = rec.events(kinds=["verify.dispatch"])[-1]["seq"] + 1
    bad = _tampers()["bls bit flip"]
    got = outcome(lambda: vset.verify_commit(CHAIN, _bid(pblock), 5,
                                             _commit(PORT, vset, privs, tamper=bad)))
    assert got == outcome(lambda: jset.verify_commit(CHAIN, _bid(jtypes), 5,
                                                     _commit(JAX, jset, jprivs, tamper=bad)))
    first_bls = min(i for i, v in enumerate(vset.validators) if "BLS" in type(v.pub_key).TYPE)
    assert got[1].startswith(f"wrong signature (#{first_bls}): ")
    assert [(e["path"], e["n"]) for e in rec.events(since=seq, kinds=["verify.dispatch"])] == [
        ("device", n_ed)]


def test_update_state_with_bls_updates_equals_jax():
    """BLS validator updates from ABCI through `validator_updates_from_abci`
    and `update_state`: a valid PoP joins the set (its next set, hash and
    priorities equal JAX's), no PoP or another key's is refused with JAX's
    message, and a removal needs none."""
    def case(ns):
        ed = [ns.Ed.from_secret(b"us-ed-%d" % i) for i in range(3)]
        gen = ns.GenesisDoc(chain_id=CHAIN, genesis_time_ns=T0, validators=[
            ns.GenesisValidator(b"", k.pub_key(), 10) for k in ed])
        gen.validate_and_complete()
        st = ns.state.make_genesis_state(gen)
        bls, other = ns.Bls.from_secret(b"us-bls"), ns.Bls.from_secret(b"us-other")
        pub = bls.pub_key().bytes()
        a = ns.abci
        blk = types_block(ns, st)
        responses = {"deliver_txs": [], "end_block": a.ResponseEndBlock()}
        out = []
        for vus in ([a.ValidatorUpdate("bls12381", pub, 7, pop=bls.pop())],
                    [a.ValidatorUpdate("bls12381", pub, 7)],
                    [a.ValidatorUpdate("bls12381", pub, 7, pop=other.pop())],
                    [a.ValidatorUpdate("bls12381", pub, 0)]):
            res = outcome(lambda: ns.execution.validator_updates_from_abci(vus))
            if res[0] != "ok":
                out.append(res)
                continue
            nxt = ns.execution.update_state(st, _bid(ns), blk, responses, res[1])
            out.append(("ok", nxt.next_validators.hash(),
                        [(v.address, v.voting_power, v.proposer_priority)
                         for v in nxt.next_validators.validators]))
            st = nxt
        return out

    out = both(case)
    assert out[0][0] == "ok" and len(out[0][2]) == 4
    assert out[1][0] == out[2][0] == "ValueError"
    assert "lacks a proof" in out[1][1] and "invalid proof" in out[2][1]
    assert out[3][0] == "ok" and len(out[3][2]) == 3


def types_block(ns, st):
    """A block at height 1 of `st`'s chain (only its height and time are read)."""
    mod = pblock if ns is PORT else jtypes
    header = mod.Header(chain_id=CHAIN, height=1, time_ns=T0 + 1,
                        validators_hash=st.validators.hash(),
                        next_validators_hash=st.next_validators.hash(),
                        proposer_address=st.validators.validators[0].address)
    return mod.Block(header=header, txs=[], last_commit=ns.Commit(0, 0, ns.BlockID(), []))


def test_staking_address_of_and_bls_rotate_equal_jax():
    """The staking app's two BLS branches: a bls12381 genesis validator's
    address, and a rotate to a bls12381 key with another key's PoP (22) and
    with its own (accepted): the same codes, logs, updates and app hash."""
    bls_secret = b"\x09" * 32

    def run(P, bls_cls):
        r = Run(P)
        bls = bls_cls.from_secret(bls_secret)
        pub = bls.pub_key().bytes()
        r.note("address", P.staking.StakingApplication._address_of("bls12381", pub))
        app = P.staking.StakingApplication()
        owner = key(P, 5)
        r.block(app, 1, P.staking.make_bond_tx(owner, 40, 0))
        rotate = P.staking.make_rotate_key_tx
        other = bls_cls.from_secret(b"\x0a" * 32).pop()
        r.check(app, rotate(owner, "bls12381", pub, 1, pop=other))
        r.check(app, rotate(owner, "bls12381", pub, 1, pop=bls.pop()))
        r.block(app, 2, rotate(owner, "bls12381", pub, 1, pop=other),
                rotate(owner, "bls12381", pub, 1, pop=bls.pop()))
        r.note("validator", app.validators.get(addr(owner)))
        return r.log

    ours, theirs = run(APORT, pbls.BlsPrivKey), run(AJAX, jbls.BlsPrivKey)
    assert ours == theirs
    assert ours[0][1] == pbls.BlsPrivKey.from_secret(bls_secret).pub_key().address()
    delivers = [v for k, v in ours if k == "deliver"]
    assert [d[1]["code"] for d in delivers[-2:]] == [APORT.staking.CODE_BAD_POP,
                                                      APORT.staking.CODE_OK]


# ---------------------------------------------------------------------------
# where the JAX package folds (aggregate commits)
# ---------------------------------------------------------------------------


def _fold_cases(ns):
    uni, uprivs = _mixed(ns, n_ed=0, n_bls=4)
    mix, mprivs = _mixed(ns, n_ed=2, n_bls=2)
    return {
        "uniform": (uni, _commit(ns, uni, uprivs)),
        "uniform, one nil and one absent": (uni, _commit(ns, uni, uprivs, nil=(1,), absent=(2,))),
        "uniform, all nil": (uni, _commit(ns, uni, uprivs, nil=(0, 1, 2, 3))),
        "uniform, a bad blob": (uni, _commit(ns, uni, uprivs,
                                             tamper=lambda i, pk, s: s[:95] if i == 3 else s)),
        "uniform, another set's size": (_mixed(ns, n_ed=0, n_bls=5)[0], _commit(ns, uni, uprivs)),
        "mixed": (mix, _commit(ns, mix, mprivs)),
        "empty": (uni, ns.Commit(0, 0, ns.BlockID(), [])),
    }


@pytest.mark.parametrize("case", list(_fold_cases(PORT)))
def test_the_fold_point_raises_exactly_where_jax_folds(case):
    """With `bls_aggregate_commits` on, the port's fold point returns an
    AggregateCommit byte-equal (encode, hash, dict) to the JAX package's
    `fold_commit` exactly where that folds, and the per-vote commit
    unchanged everywhere else; with the knob off it never folds."""
    pset, pc = _fold_cases(PORT)[case]
    jset, jc = _fold_cases(JAX)[case]
    theirs = jagg.fold_commit(jc, jset, CHAIN)
    folds = theirs is not None
    assert folds == (case in ("uniform", "uniform, one nil and one absent"))

    class _Cfg:
        bls_aggregate_commits = True

    rec = FlightRecorder(size=16)
    holder = type("Holder", (), {"config": _Cfg(), "recorder": rec,
                                 "sm_state": types.SimpleNamespace(chain_id=CHAIN)})()
    fold = pcs.ConsensusState._maybe_fold_commit
    ours = fold(holder, pc, pset)
    if folds:
        assert type(ours).__name__ == "AggregateCommit"
        assert (ours.encode(), ours.hash(), ours.to_dict()) == \
            (theirs.encode(), theirs.hash(), theirs.to_dict())
        assert [e["kind"] for e in rec.events()] == ["commit.aggregate"]
    else:
        assert ours is pc
    _Cfg.bls_aggregate_commits = False
    assert fold(holder, pc, pset) is pc


# ---------------------------------------------------------------------------
# nets: two port and two JAX validators
# ---------------------------------------------------------------------------


def _net_genesis(kind, privs, chain):
    if kind == "jax":
        from tendermint_tpu.types.params import BlockParams, ConsensusParams
        G, V = jtypes.GenesisDoc, jtypes.GenesisValidator
    else:
        from tendermint_tpu_torch.types.params import BlockParams, ConsensusParams
        G, V = pgenesis.GenesisDoc, pgenesis.GenesisValidator
    return G(chain_id=chain, genesis_time_ns=T0,
             consensus_params=ConsensusParams(block=BlockParams(time_iota_ms=1)),
             validators=[V(k.pub_key().address(), k.pub_key(), 10,
                           pop=k.pop() if hasattr(k, "pop") else b"") for k in privs])


def _net_node(kind, home, gen, priv, aggregate=True):
    """A node of either package as the JAX BLS nets run them (their
    timeouts, timeout_commit 0.1 s, PEX off); the port's engine on the CPU."""
    if kind == "jax":
        from tendermint_tpu.config import test_config
        from tendermint_tpu.node import Node
        from tendermint_tpu.types import MockPV
    else:
        from tendermint_tpu_torch.config import test_config
        from tendermint_tpu_torch.node import Node
        from tendermint_tpu_torch.types.priv_validator import MockPV
    cfg = test_config(home)
    cfg.rpc.laddr = ""
    cfg.base.db_backend = "memdb"
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.consensus.skip_timeout_commit = False
    cfg.consensus.timeout_commit = 0.1
    cfg.consensus.timeout_propose = 2.0
    cfg.consensus.timeout_prevote = 0.5
    cfg.consensus.timeout_precommit = 0.5
    cfg.consensus.bls_aggregate_commits = aggregate
    if kind == "jax":
        return Node(cfg, gen, priv_validator=MockPV(priv), db_backend="memdb")
    cfg.tpu.enabled = True
    # /metrics on a free port: the node's bls_tier gauge is read below
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    return Node(cfg, gen, priv_validator=MockPV(priv), db_backend="memdb", device="cpu")


async def _run_net(tmp_path, make_priv, chain, aggregate):
    """Validators 0 and 2 (by address) on the JAX package, 1 and 3 on the
    port, up to height 3: blocks 1-3 byte-equal on all four, and every
    stored commit a per-vote Commit.  Returns the commits' dicts."""
    kinds = ("jax", "port", "jax", "port")
    seeds = [b"%s-%d" % (chain.encode(), i) for i in range(4)]
    order = sorted(range(4), key=lambda i: make_priv(PORT, i, seeds[i]).pub_key().address())
    gens = {kind: _net_genesis(kind, [make_priv(ns, i, seeds[i]) for i in order], chain)
            for kind, ns in (("jax", JAX), ("port", PORT))}
    nodes = []
    try:
        for slot, i in enumerate(order):
            kind = kinds[slot]
            ns = JAX if kind == "jax" else PORT
            nodes.append(_net_node(kind, str(tmp_path / f"n{slot}"), gens[kind],
                                   make_priv(ns, i, seeds[i]), aggregate=aggregate))
        for n in nodes:
            await n.start()
        for i in range(4):
            for j in range(i + 1, 4):
                await nodes[i].switch.dial_peer(
                    f"{nodes[j].node_key.id}@{nodes[j].switch.transport.listen_addr}")

        async def wait():
            while not all(n.block_store.height() >= 3 for n in nodes):
                await asyncio.sleep(0.05)

        await asyncio.wait_for(wait(), 120.0)
        for h in (1, 2, 3):
            raw = {(pcodec if k == "port" else jcodec).dumps(n.block_store.load_block(h))
                   for n, k in zip(nodes, kinds)}
            assert len(raw) == 1, f"height {h} differs"
        commits = []
        for n, k in zip(nodes, kinds):
            c = n.block_store.load_block_commit(2)
            assert type(c) is (pblock.Commit if k == "port" else jtypes.Commit), type(c)
            commits.append(c.to_dict())
        assert all(c == commits[0] for c in commits)
        # a port node whose genesis holds BLS validators reports the C tier
        for n, k in zip(nodes, kinds):
            if k == "port":
                text = n.metrics_provider.exposition().decode()
                assert re.search(r"^tendermint_verify_bls_tier\{[^}]*\} 1\.0$", text, re.M), \
                    [ln for ln in text.splitlines() if "bls_tier" in ln]
        return commits[0]
    finally:
        for n in nodes:
            if n.is_running:
                await n.stop()
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)


async def test_mixed_set_net_of_port_and_jax_nodes_commits_without_aggregation(tmp_path):
    """Two ed25519 and two BLS validators in one set, aggregation on (the
    default): consensus commits through per-scheme verify routing, and every
    stored commit is a per-vote Commit (JAX
    TestBlsNets.test_mixed_set_net_commits_without_aggregation)."""
    def make_priv(ns, i, seed):
        return (ns.Bls if i % 2 else ns.Ed).from_secret(seed)

    commit = await _run_net(tmp_path, make_priv, "bls-mixed-net", aggregate=True)
    assert "agg_sig" not in commit


async def test_uniform_bls_net_with_aggregation_off_commits_per_vote_as_jax(tmp_path):
    """Four BLS validators with `bls_aggregate_commits = false` on every
    node: per-vote commits, byte-equal between the packages."""
    def make_priv(ns, i, seed):
        return ns.Bls.from_secret(seed)

    commit = await _run_net(tmp_path, make_priv, "bls-uniform-net", aggregate=False)
    assert len(commit["signatures"]) == 4
