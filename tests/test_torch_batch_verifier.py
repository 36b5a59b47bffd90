"""The port's batch verifier and commit verification
(tendermint_tpu_torch/crypto/batch_verifier.py, types/validator.py) against
the JAX package's, on the CPU (device="cpu": the kernel wrappers run their
plain torch versions).

Same inputs through both packages; verdicts, host-prep arrays, exceptions
and their messages must be identical.  Also: the JAX package's device
state carries across (from_jax_state), entry points never drift onto the
CPU, the port imports neither jax nor the JAX package, and only a failure
of the engine's device work is its own crypto.batch.EngineError.
"""

import ast
import os
import threading
import time

import numpy as np
import pytest
import torch

import tendermint_tpu.types as jtypes
from tendermint_tpu.crypto import batch as jbatch_hook
from tendermint_tpu.crypto import batch_verifier as jbvm
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.libs.tracing import FlightRecorder as JFlightRecorder
from tendermint_tpu.ops import ed25519_table as jtab
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.crypto import hostprep
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs.tracing import FlightRecorder
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
    """A key the batch cannot verify and whose own verify raises is a False
    verdict, as in the JAX package."""
    from tendermint_tpu.types.validator import mixed_batch_verify as jax_mixed

    assert mixed_batch_verify([object()], [b"m"], [b"s" * 64]) == [False]
    assert jax_mixed([object()], [b"m"], [b"s" * 64]) == [False]


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



# ---------------------------------------------------------------------------
# chunked single shot, RTT probe, cold start, TableCache warmup and rebuild
# ---------------------------------------------------------------------------

CHUNKED_N = 40


def _chunked_batch():
    """40 signatures over 8 rows with a corrupt signature and an
    out-of-range row (the JAX package's TestRTTProbe shape)."""
    pks, msgs, sigs = make_sigs(8, seed=5)
    rows = [Ed25519PrivKey.from_secret(f"key-{i}".encode()) for i in range(8)]
    signed = [k.sign(m) for k, m in zip(rows, msgs)]
    idxs = [i % 8 for i in range(CHUNKED_N)]
    ms = [msgs[i] for i in idxs]
    ss = [signed[i] for i in idxs]
    ss[11] = bytes(64)
    ss[27] = ss[27][:3] + bytes([ss[27][3] ^ 1]) + ss[27][4:]
    idxs[33] = 999
    return pks, idxs, ms, ss


@pytest.fixture(scope="module")
def jax_chunked_verdicts():
    """The JAX package's chunked verify_indexed (chunk 16) on the batch."""
    pks, idxs, ms, ss = _chunked_batch()
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvm, "_CHUNK", 16)
    try:
        v = jbvm.BatchVerifier()
        v._pallas = False  # the XLA kernel: any chunk shape
        table = jbvm.PubkeyTable(pks, v)
        table.chunked_single_shot = True
        return table.verify_indexed(idxs, ms, ss)
    finally:
        mp.undo()


@pytest.mark.parametrize("chunk,depth", [(16, 1), (16, 2), (16, 3), (32, 2)])
def test_chunked_matches_jax_and_monolithic(chunk, depth, jax_chunked_verdicts, monkeypatch):
    """The chunked single shot (ragged last chunk, every ring depth) equals
    the JAX package's chunked verdicts and the port's monolithic path."""
    monkeypatch.setattr(bvm, "_CHUNK", chunk)
    pks, idxs, ms, ss = _chunked_batch()
    rec = FlightRecorder()
    table = bvm.PubkeyTable(pks, bvm.BatchVerifier(device=CPU, recorder=rec, chunk_depth=depth))
    expect = [i not in (11, 27, 33) for i in range(CHUNKED_N)]
    assert jax_chunked_verdicts == expect
    table.chunked_single_shot = True
    chunked = table.verify_indexed(idxs, ms, ss)
    path = "chunked" if CHUNKED_N >= 2 * chunk else "indexed"  # 40 < 2 * 32: not eligible
    assert table.verifier.last_dispatch["path"] == path
    table.chunked_single_shot = False
    assert chunked == table.verify_indexed(idxs, ms, ss) == expect
    assert [e["path"] for e in rec.events(kinds=["verify.dispatch"])] == [path, "indexed"]


def test_chunked_slot_reuse_waits_for_its_chunk(monkeypatch):
    """With one slot every chunk refills the buffers the previous chunk
    used: its verdicts must be read before the refill."""
    monkeypatch.setattr(bvm, "_CHUNK", 8)
    pks, idxs, ms, ss = _chunked_batch()
    table = bvm.PubkeyTable(pks, bvm.BatchVerifier(device=CPU, chunk_depth=1))
    table.chunked_single_shot = True
    seen = []
    fill = bvm._ChunkSlot.fill

    def spy(slot, cnt, *arrays):
        seen.append(id(slot))
        fill(slot, cnt, *arrays)

    monkeypatch.setattr(bvm._ChunkSlot, "fill", spy)
    assert table.verify_indexed(idxs[:24], ms[:24], ss[:24]) == [i != 11 for i in range(24)]
    assert len(seen) == 3 and len(set(seen)) == 1


@pytest.mark.parametrize("chunked", [False, True])
def test_only_device_failures_are_engine_errors(chunked, monkeypatch):
    """A signature of the wrong type (a peer's str) fails the host prep with
    TypeError on the monolithic and the chunked path alike; a launch that
    raises is the engine's own crypto.batch.EngineError on both."""
    from tendermint_tpu_torch.crypto.batch import EngineError
    from tendermint_tpu_torch.ops import ed25519_cuda

    monkeypatch.setattr(bvm, "_CHUNK", 8)
    pks, idxs, ms, ss = _chunked_batch()
    table = bvm.PubkeyTable(pks, bvm.BatchVerifier(device=CPU))
    table.chunked_single_shot = chunked
    bad = list(ss[:24])
    bad[5] = "x" * 64
    with pytest.raises(TypeError) as ei:
        table.verify_indexed(idxs[:24], ms[:24], bad)
    assert not isinstance(ei.value, EngineError)

    def launch_fails(*args, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ed25519_cuda, "verify_indexed", launch_fails)
    with pytest.raises(EngineError, match="kernel launch failed"):
        table.verify_indexed(idxs[:24], ms[:24], ss[:24])


def test_rtt_probe_shape_and_caching():
    rec = FlightRecorder()
    bv = bvm.BatchVerifier(device=CPU, recorder=rec)
    probe = bv.probe_dispatch_rtt(samples=2)
    assert set(probe) == {"dispatch_rtt_ms", "prep_ms_per_chunk", "chunked_selected"}
    assert probe["dispatch_rtt_ms"] > 0 and probe["prep_ms_per_chunk"] > 0
    assert bv.probe_dispatch_rtt() is probe  # cached
    assert isinstance(bv.chunked_auto(), bool)
    (ev,) = rec.events(kinds=["verify.chunked"])
    assert ev["selected"] == bool(probe["chunked_selected"]) and ev["shards"] == 1
    assert bvm.BatchVerifier(device=CPU, chunk_size=100).effective_chunk() == 100
    assert bv.effective_chunk() == bvm._CHUNK


@pytest.mark.parametrize("selected", [0.0, 1.0])
def test_auto_selection_drives_indexed_path(selected, monkeypatch):
    """chunked_single_shot=None defers to the probe's verdict; both
    verdicts give the same results."""
    monkeypatch.setattr(bvm, "_CHUNK", 16)
    pks, idxs, ms, ss = _chunked_batch()
    v = bvm.BatchVerifier(device=CPU)
    v.rtt_probe = {"dispatch_rtt_ms": 1.0, "prep_ms_per_chunk": 2.0, "chunked_selected": selected}
    table = bvm.PubkeyTable(pks, v)
    assert table.chunked_single_shot is None  # auto by default
    assert table.verify_indexed(idxs, ms, ss) == [i not in (11, 27, 33) for i in range(CHUNKED_N)]
    assert v.last_dispatch["path"] == ("chunked" if selected else "indexed")


def test_probe_failure_keeps_the_monolithic_path(monkeypatch):
    v = bvm.BatchVerifier(device=CPU)
    monkeypatch.setattr(v, "probe_dispatch_rtt", lambda: 1 / 0)
    assert v.chunked_auto() is False


def test_install_probes_in_the_background(hooks):
    v = bvm.BatchVerifier(device=CPU).install()
    deadline = time.time() + 30
    while v.rtt_probe is None and time.time() < deadline:
        time.sleep(0.01)
    assert v.rtt_probe is not None


def _fake_card(monkeypatch, lib):
    """A CPU verifier routed as if its device path needed the CUDA
    library, whose build is `lib`."""
    rec = FlightRecorder()
    bv = bvm.BatchVerifier(device=CPU, min_device_batch=2, recorder=rec)
    bv._needs_library = True
    monkeypatch.setattr(bvm._build, "loaded", lambda: False)
    monkeypatch.setattr(bvm._build, "lib", lib)
    return bv, rec


def test_failed_build_raises_instead_of_serving_the_host(sigs16, jax_verdicts, monkeypatch):
    """In warmup mode the host path serves (host-cold) only while the
    build is in flight; a failed build makes every later device-routed
    verify raise.  Below min_device_batch the host path still serves."""
    gate = threading.Event()

    def failing_build():
        gate.wait(30)
        raise RuntimeError("nvcc failed on ed25519_ladder.cu")

    bv, rec = _fake_card(monkeypatch, failing_build)
    bv.start_warmup()
    assert bv.verify(*sigs16) == jax_verdicts
    assert bv.last_dispatch["path"] == "host-cold"
    gate.set()
    deadline = time.time() + 30
    while not rec.events(kinds=["verify.bucket_compile"]) and time.time() < deadline:
        time.sleep(0.01)
    (ev,) = rec.events(kinds=["verify.bucket_compile"])
    assert ev["ok"] is False and ev["bucket"] == 2
    for _ in range(2):
        with pytest.raises(RuntimeError, match="failed to build.*nvcc failed"):
            bv.verify(*sigs16)
    pks, msgs, sigs = sigs16
    assert bv.verify(pks[:1], msgs[:1], sigs[:1]) == jax_verdicts[:1]
    assert bv.last_dispatch["path"] == "host"
    bv.rewarm(len(pks))  # does not raise, and starts no second build
    assert len(rec.events(kinds=["verify.bucket_compile"])) == 1


def test_warm_build_flips_to_the_device(sigs16, jax_verdicts, monkeypatch):
    gate = threading.Event()
    built = []

    def build():
        gate.wait(30)
        built.append(True)

    bv, rec = _fake_card(monkeypatch, build)
    bv.start_warmup()
    bv.rewarm(16)  # a second ask while the build is in flight starts nothing
    assert bv.verify(*sigs16) == jax_verdicts
    assert bv.last_dispatch["path"] == "host-cold"
    gate.set()
    deadline = time.time() + 30
    while not rec.events(kinds=["verify.bucket_compile"]) and time.time() < deadline:
        time.sleep(0.01)
    monkeypatch.setattr(bvm._build, "loaded", lambda: bool(built))
    assert bv.verify(*sigs16) == jax_verdicts
    assert bv.last_dispatch["path"] == "device"
    assert built == [True]
    assert [e["ok"] for e in rec.events(kinds=["verify.bucket_compile"])] == [True]


def test_warmup_on_the_cpu_builds_nothing(sigs16, jax_verdicts, monkeypatch):
    monkeypatch.setattr(bvm._build, "lib", lambda: 1 / 0)
    bv = bvm.BatchVerifier(device=CPU).start_warmup()
    assert bv.verify(*sigs16) == jax_verdicts
    assert bv.last_dispatch["path"] == "device"
    never = bvm.BatchVerifier(device=CPU, min_device_batch=1 << 20)
    never._needs_library = True
    never.start_warmup()  # every batch stays on the host: nothing to build
    assert not never._building


def test_loaded_never_waits_on_the_build_lock():
    from tendermint_tpu_torch.ops import _build

    with _build._lock:  # a build in flight holds it
        t = threading.Thread(target=_build.loaded)
        t.start()
        t.join(5)
        assert not t.is_alive()
    assert _build.loaded() is (_build._lib is not None)


def test_device_const_uploads_once_under_contention():
    """Many threads asking for one constant at once get one tensor."""
    import sys

    from tendermint_tpu_torch.ops import _check

    arr = np.arange(64, dtype=np.int32)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(_check.device_const(arr, torch.device(CPU))))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 16 and len({id(t) for t in got}) == 1


def test_dispatch_events_carry_the_jax_fields(sigs16):
    ours, theirs = FlightRecorder(), JFlightRecorder()
    bvm.BatchVerifier(device=CPU, min_device_batch=1 << 20, recorder=ours).verify(*sigs16)
    jbvm.BatchVerifier(min_device_batch=1 << 20, recorder=theirs).verify(*sigs16)
    (a,), (b,) = ours.events(kinds=["verify.dispatch"]), theirs.events(kinds=["verify.dispatch"])
    assert a.keys() == b.keys() and a["path"] == b["path"] == "host"


def test_table_cache_records_hits_and_misses(sigs16, jax_verdicts):
    pks, msgs, sigs = sigs16
    rec = FlightRecorder()
    cache = bvm.TableCache(bvm.BatchVerifier(device=CPU, recorder=rec), tabulated=False)
    for _ in range(2):
        assert cache.verify_indexed(b"set", lambda: pks, list(range(16)), msgs, sigs) == jax_verdicts
    assert [(e["hit"], e["n"]) for e in rec.events(kinds=["verify.table"])] == [(False, 16), (True, 16)]


def _wait_for(cond, timeout=60):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    assert cond()


def test_table_cache_declines_while_building_in_warmup(sigs16, jax_verdicts, hooks):
    """Node mode: a miss builds the table in the background and declines
    meanwhile; verify_commit's flat fallback serves; then the table does."""
    pks, msgs, sigs = sigs16
    gate = threading.Event()
    rec = FlightRecorder()
    bv = bvm.BatchVerifier(device=CPU, recorder=rec).start_warmup()
    cache = bvm.TableCache(bv, tabulated=False)
    real_table_for = cache.table_for

    def slow_table_for(key, rows):
        gate.wait(30)
        return real_table_for(key, rows)

    cache.table_for = slow_table_for
    assert cache.verify_indexed(b"set", lambda: pks[:8], list(range(8)), msgs[:8], sigs[:8]) is None
    assert cache.verify_indexed(b"set", lambda: pks[:8], list(range(8)), msgs[:8], sigs[:8]) is None
    gate.set()
    _wait_for(lambda: cache.has_table(b"set") and not cache._building)
    assert cache.verify_indexed(b"set", None, list(range(8)), msgs[:8], sigs[:8]) == jax_verdicts[:8]
    assert [e["hit"] for e in rec.events(kinds=["verify.table"])] == [False, False, True]
    # through the hooks: a declining cache leaves the commit to the flat verifier
    (vset, bid, commit), (jset, jbid, jcommit) = _commit_pair(tamper=3)
    bv.install()
    cold = bvm.TableCache(bv, tabulated=False).install()
    assert _outcome(lambda: vset.verify_commit(CHAIN_ID, bid, 5, commit)) == _outcome(
        lambda: jset.verify_commit(CHAIN_ID, jbid, 5, jcommit))
    assert bv.last_dispatch["path"] == "device"
    _wait_for(lambda: cold.has_table(vset.pubkeys_digest()) and not cold._building)


def test_rebuild_warms_the_set_and_drops_the_profile_on_resize(sigs16, monkeypatch):
    pks, msgs, sigs = sigs16
    rec = FlightRecorder()
    cache = bvm.TableCache(bvm.BatchVerifier(device=CPU, recorder=rec), tabulated=False)
    dropped = []
    monkeypatch.setattr(bvm, "invalidate_tabulated_profile", lambda: dropped.append(True))

    def rebuilds():
        return [e for e in rec.events(kinds=["verify.table_rebuild"])]

    assert cache.rebuild(b"a", pks[:4]) is True
    assert cache.rebuild(b"a", pks[:4]) is False  # cached or building
    _wait_for(lambda: len(rebuilds()) == 1)
    assert rebuilds()[0]["ok"] is True and rebuilds()[0]["validators"] == 4
    assert cache.has_table(b"a") and dropped == []
    assert cache.rebuild(b"b", lambda: pks[4:8]) is True  # same size: the profile stays
    _wait_for(lambda: len(rebuilds()) == 2)
    assert dropped == []
    assert cache.rebuild(b"c", pks[:6]) is True  # another size: the profile goes
    _wait_for(lambda: len(rebuilds()) == 3)
    assert dropped == [True]
    warm = [e for e in rec.events(kinds=["verify.dispatch"])]
    assert [e["n"] for e in warm] == [4, 4, 6]
    assert cache.verify_indexed(b"c", None, list(range(6)), msgs[:6], sigs[:6]) == \
        bvm.BatchVerifier(device=CPU).verify(pks[:6], msgs[:6], sigs[:6])


def test_invalidate_tabulated_profile():
    bvm._tabulated_verdict["some card"] = True
    bvm.invalidate_tabulated_profile()
    assert bvm._tabulated_verdict == {}
