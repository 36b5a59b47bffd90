"""The port's batch verifier and commit verification
(tendermint_tpu_torch/crypto/batch_verifier.py, types/validator.py) against
the JAX package's, on the CPU (device="cpu": the kernel wrappers run their
plain torch versions).

Same inputs through both packages; verdicts, host-prep arrays, exceptions
and their messages must be identical.  Also: the JAX package's device
state carries across (from_jax_state), entry points never drift onto the
CPU, and the port imports neither jax nor the JAX package.
"""

import ast
import os

import numpy as np
import pytest
import torch

import tendermint_tpu.types as jtypes
from tendermint_tpu.crypto import batch as jbatch_hook
from tendermint_tpu.crypto import batch_verifier as jbvm
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.ops import ed25519_table as jtab
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.crypto import hostprep
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
from tendermint_tpu_torch.types.validator import (
    NotEnoughVotingPowerError,
    Validator,
    ValidatorSet,
    mixed_batch_verify,
)
from tendermint_tpu_torch.types.vote import Vote

# B <= 16: intra-op threads buy nothing here and contend with other test workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_ID = "torch-port"
CPU = "cpu"


def make_sigs(n, seed=0):
    """n (pubkey, msg, sig) triples with about a third corrupted."""
    rng = np.random.default_rng(seed)
    keys = [Ed25519PrivKey.from_secret(f"key-{i}".encode()) for i in range(n)]
    pks = [k.pub_key().bytes() for k in keys]
    msgs = [f"message-{i}".encode() for i in range(n)]
    sigs = []
    for k, m in zip(keys, msgs):
        sig = k.sign(m)
        if rng.random() < 0.35:
            b = bytearray(sig)
            b[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        sigs.append(sig)
    return pks, msgs, sigs


@pytest.fixture(scope="module")
def sigs16():
    return make_sigs(16)


@pytest.fixture(scope="module")
def jax_verdicts(sigs16):
    return jbvm.BatchVerifier().verify(*sigs16)


@pytest.fixture
def hooks():
    yield
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)


def test_keys_match_jax_keys():
    for i in range(3):
        secret = f"k-{i}".encode()
        ours, theirs = Ed25519PrivKey.from_secret(secret), JPrivKey.from_secret(secret)
        assert ours.pub_key().bytes() == theirs.pub_key().bytes()
        assert ours.pub_key().address() == theirs.pub_key().address()
        assert ours.sign(b"m") == theirs.sign(b"m")
        assert ours.pub_key().verify(b"m", ours.sign(b"m"))
        assert not ours.pub_key().verify(b"n", ours.sign(b"m"))


def test_host_prep_c_matches_numpy_and_jax(sigs16, monkeypatch):
    assert hostprep.have_fast_prep()
    pks, msgs, sigs = sigs16
    items = [(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
    items[3] = None
    items[5] = (pks[5], msgs[5], sigs[5][:63])
    fast = bvm._scalar_rows(items)
    want = jbvm._scalar_rows(items)
    monkeypatch.setattr(hostprep, "prep_scalar_rows", lambda items: None)
    slow = bvm._scalar_rows(items)
    for f, s, w in zip(fast, slow, want):
        np.testing.assert_array_equal(f, s)
        np.testing.assert_array_equal(f, w)


def test_prepare_batch_matches_jax(sigs16):
    pks, msgs, sigs = sigs16
    pks = list(pks)
    pks[2] = b"\xff" * 32
    for ours, theirs in zip(bvm.prepare_batch(pks, msgs, sigs), jbvm.prepare_batch(pks, msgs, sigs)):
        np.testing.assert_array_equal(ours, theirs)


def test_flat_verify_matches_jax(sigs16, jax_verdicts):
    got = bvm.BatchVerifier(device=CPU).verify(*sigs16)
    assert got == jax_verdicts
    assert got == [em.verify(*t) for t in zip(*sigs16)]
    assert False in got and True in got


def test_min_device_batch_routes_to_host(sigs16, jax_verdicts):
    bv = bvm.BatchVerifier(device=CPU, min_device_batch=1 << 20)
    assert bv.verify(*sigs16) == jax_verdicts
    assert bv.last_dispatch["path"] == "host"


@pytest.mark.parametrize("tabulated", [False, True])
def test_pubkey_table_verify_indexed_matches_jax(sigs16, jax_verdicts, tabulated):
    pks, msgs, sigs = sigs16
    table = bvm.PubkeyTable(pks[:8], device=CPU, tabulated=tabulated)
    idxs = [i % 8 for i in range(16)]
    got = table.verify_indexed(idxs, msgs, sigs)
    assert table.verifier.last_dispatch["path"] == ("tabulated" if tabulated else "indexed")
    # signatures 8..15 point at rows 0..7: the wrong key, rejected
    assert got[:8] == jax_verdicts[:8] and got[8:] == [False] * 8
    assert table.verify_indexed([99, -1], msgs[:2], sigs[:2]) == [False, False]


def test_auto_tabulated_is_off_on_cpu(sigs16):
    table = bvm.PubkeyTable(sigs16[0][:4], device=CPU)
    table.verify_indexed([0, 1], sigs16[1][:2], sigs16[2][:2])
    assert table.tabulated is False


def test_table_cache_routes_and_caches(sigs16, jax_verdicts, hooks):
    pks, msgs, sigs = sigs16
    cache = bvm.TableCache(device=CPU, tabulated=False).install()
    got = batch_hook.get_indexed_verifier()(b"set", lambda: pks, list(range(16)), msgs, sigs)
    assert got == jax_verdicts
    assert cache.has_table(b"set")
    assert cache.verify_indexed(b"set", None, list(range(16)), msgs, sigs) == jax_verdicts


def test_from_jax_state_round_trip(sigs16, jax_verdicts):
    pks, msgs, sigs = sigs16
    jax_table = jbvm.PubkeyTable(pks[:4])
    rows = np.asarray(jax_table.neg_a_rows)
    tables = np.asarray(jtab.build_window_tables(rows))
    ours = bvm.PubkeyTable(pks[:4], device=CPU, tabulated=True)
    np.testing.assert_array_equal(ours.neg_a_rows.numpy(), rows)
    np.testing.assert_array_equal(ours.build_tables().numpy(), tables)
    for carried_tables, path in ((tables, "tabulated"), (None, "indexed")):
        carried = bvm.from_jax_state(rows, carried_tables, device=CPU)
        assert carried.pubkeys == pks[:4]
        assert carried.verify_indexed([0, 1, 2, 3], msgs[:4], sigs[:4]) == jax_verdicts[:4]
        assert carried.verifier.last_dispatch["path"] == path
    bad = bvm.from_jax_state(np.stack([rows[0], bvm.IDENTITY_ROW]), None, device=CPU)
    assert bad.row_valid.tolist() == [True, False]


def test_entry_points_never_drift_onto_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (bvm.BatchVerifier, bvm.TableCache, lambda: bvm.PubkeyTable([b"\x01" * 32])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert bvm.BatchVerifier(device=CPU).device.type == "cpu"


def test_mixed_batch_verify_rejects_other_key_types():
    with pytest.raises(TypeError, match="ed25519 only"):
        mixed_batch_verify([object()], [b"m"], [b"s" * 64])


# ---------------------------------------------------------------------------
# commit verification, port vs JAX package
# ---------------------------------------------------------------------------


def _commit_pair(n=8, absent=(), nil=(), tamper=None, height=5):
    """The same signed commit built with each package's types."""
    keys = [Ed25519PrivKey.from_secret(f"cv-{i}".encode()) for i in range(n)]
    jkeys = [JPrivKey.from_secret(f"cv-{i}".encode()) for i in range(n)]
    vset = ValidatorSet([Validator.new(k.pub_key(), 10 + i) for i, k in enumerate(keys)])
    jset = jtypes.ValidatorSet([jtypes.Validator.new(k.pub_key(), 10 + i) for i, k in enumerate(jkeys)])
    assert [v.address for v in vset.validators] == [v.address for v in jset.validators]
    by_addr = {k.pub_key().address(): k for k in keys}
    bid = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))
    jbid = jtypes.BlockID(b"\x01" * 32, jtypes.PartSetHeader(1, b"\x02" * 32))
    sigs, jsigs = [], []
    for i, v in enumerate(vset.validators):
        if i in absent:
            sigs.append(CommitSig.absent())
            jsigs.append(jtypes.CommitSig.absent())
            continue
        vote = Vote(PRECOMMIT_TYPE, height, 0, BlockID() if i in nil else bid, 1000 + i, v.address, i)
        vote.signature = by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID))
        if i == tamper:
            vote.signature = bytes([vote.signature[0] ^ 1]) + vote.signature[1:]
        cs = vote.commit_sig()
        sigs.append(cs)
        jsigs.append(jtypes.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp_ns, cs.signature))
    return (vset, bid, Commit(height, 0, bid, sigs)), (jset, jbid, jtypes.Commit(height, 0, jbid, jsigs))


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # the outcome under comparison is the exception itself
        return type(e).__name__, str(e)


CASES = {
    "valid": {},
    "nil votes": {"nil": (1, 2)},
    "tampered": {"tamper": 5},
    "over a third absent": {"absent": (0, 1, 2, 3)},
    "two absent": {"absent": (3, 6)},
}


@pytest.mark.parametrize("route", ["indexed", "flat"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_commit_matches_jax(case, route, hooks):
    (vset, bid, commit), (jset, jbid, jcommit) = _commit_pair(**CASES[case])
    bv = bvm.BatchVerifier(device=CPU).install()
    if route == "indexed":
        bvm.TableCache(bv, tabulated=True).install()
    for check in (
        lambda s, b, c: s.verify_commit(CHAIN_ID, b, 5, c),
        lambda s, b, c: s.verify_commit_trusting(CHAIN_ID, b, 5, c),
        lambda s, b, c: s.verify_commit(CHAIN_ID, b, 6, c),
        lambda s, b, c: s.verify_future_commit(s, CHAIN_ID, b, 5, c),
    ):
        ours = _outcome(lambda: check(vset, bid, commit))
        theirs = _outcome(lambda: check(jset, jbid, jcommit))
        assert ours == theirs
    if case == "tampered":
        assert ours[1].startswith("wrong signature (#5)")


def test_commit_errors_match_jax():
    (vset, bid, commit), (jset, jbid, jcommit) = _commit_pair()
    other, jother = BlockID(b"\x03" * 32, bid.parts_header), jtypes.BlockID(b"\x03" * 32, jbid.parts_header)
    short = Commit(5, 0, bid, commit.signatures[:7])
    jshort = jtypes.Commit(5, 0, jbid, jcommit.signatures[:7])
    assert _outcome(lambda: vset.verify_commit(CHAIN_ID, other, 5, commit)) == _outcome(
        lambda: jset.verify_commit(CHAIN_ID, jother, 5, jcommit))
    assert _outcome(lambda: vset.verify_commit(CHAIN_ID, bid, 5, short)) == _outcome(
        lambda: jset.verify_commit(CHAIN_ID, jbid, 5, jshort))
    assert _outcome(lambda: vset.verify_commit_trusting(CHAIN_ID, bid, 5, commit, 1, 4)) == _outcome(
        lambda: jset.verify_commit_trusting(CHAIN_ID, jbid, 5, jcommit, 1, 4))
    assert vset.pubkeys_digest() == jset.pubkeys_digest()
    assert vset.total_voting_power() == jset.total_voting_power()
    addr = vset.validators[3].address
    assert vset.get_by_address(addr)[0] == jset.get_by_address(addr)[0] == 3


def test_not_enough_power_is_the_ported_error():
    (vset, bid, commit), _ = _commit_pair(absent=(0, 1, 2, 3))
    with pytest.raises(NotEnoughVotingPowerError, match="insufficient voting power"):
        vset.verify_commit(CHAIN_ID, bid, 5, commit)


def test_validator_set_construction_errors_match_jax():
    k = Ed25519PrivKey.from_secret(b"dup").pub_key()
    jk = JPrivKey.from_secret(b"dup").pub_key()
    for powers in ((10, 10), (-1,), (0,)):
        ours = _outcome(lambda: ValidatorSet([Validator.new(k, p) for p in powers]))
        theirs = _outcome(lambda: jtypes.ValidatorSet([jtypes.Validator.new(jk, p) for p in powers]))
        assert ours[0] == theirs[0]


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tendermint_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tendermint_tpu"), f"{path} imports {mod}"


def test_hook_state_is_separate_from_the_jax_package(hooks):
    bvm.BatchVerifier(device=CPU).install()
    assert jbatch_hook.get_verifier() is jbatch_hook.host_batch_verify
    assert batch_hook.get_verifier() is not batch_hook.host_batch_verify

