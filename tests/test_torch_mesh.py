"""The verify mesh (tendermint_tpu_torch/crypto/backend.py `resolve_mesh` and
`Mesh`, the sharded paths of crypto/batch_verifier.py and the sharded fold of
crypto/bls/cuda_tier.py) against the JAX package's mesh on the conftest's 8
virtual CPU devices.  The port's shards are virtual CPU shards
(`Mesh(["cpu"] * m)`): each runs the kernels' plain versions on its slice.

Same inputs through both packages, tolerance 0:
- `resolve_mesh`'s triple for every mode with caps 0, 1, 4 and 8 (the port
  seeing 8 virtual CPU shards); a failing probe degrades in JAX and raises
  in the port; a card named with its index pins the mesh to it (4 cards
  stood in for on the CPU; JAX has no per-node device to compare with);
- `_bucket` and `effective_chunk` over a grid of batch sizes and shard
  counts 1, 2, 3, 4, 6 and 8;
- flat `verify` of 10, 13 and 64 signatures on 8 shards, its dispatch
  event's fields and `shards`;
- the sharded indexed path against JAX's sharded and one-device paths, one
  liar at `shard * 8 + 3` on each of the 8 shards (through a table carried
  over from JAX's replicated rows by `from_jax_state`), and the forced
  chunked single shot with a chunk size (12) that 8 does not divide;
- `_mesh_bucket` for meshes of 1, 2, 3, 4, 6 and 8 shards, and the sharded
  G1 / G2 folds limb-equal to `jax_tier.aggregate_g1/g2(pts, mesh=...)` at
  3 points on 4 shards (one-point shards), 100 points on 4 shards and 3
  points on a 3-shard mesh (which folds unsharded in both), and to the
  port's one-device fold and the pure fold.
The JAX side compiles its sharded ladder at buckets 16 and 64, its fused
and chunked jits at 64 and 16, and its fold at three (bucket, mesh) keys.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from tendermint_tpu.crypto import backend as jbackend
from tendermint_tpu.crypto import batch_verifier as jbvm
from tendermint_tpu.crypto.bls import jax_tier
from tendermint_tpu.libs.tracing import FlightRecorder as JFlightRecorder
from tendermint_tpu_torch.crypto import backend as pbackend
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto.bls import cuda_tier, curve, scheme
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs.tracing import FlightRecorder

torch.set_num_threads(1)

CPU = "cpu"
SEED = 2424


def jmesh(m):
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices (conftest XLA_FLAGS)")
    return JMesh(np.array(devs[:m]), ("batch",))


def pmesh(m):
    return pbackend.Mesh([CPU] * m)


def signed(n, keys=16):
    """n (pubkey, msg, sig) triples over `keys` seeded keys, all valid, and
    the row index of each."""
    ks = [Ed25519PrivKey.from_secret(f"mesh-{i}".encode()) for i in range(keys)]
    idxs = [i % keys for i in range(n)]
    msgs = [f"mesh-message-{i}".encode() for i in range(n)]
    pks = [ks[i].pub_key().bytes() for i in idxs]
    sigs = [ks[i].sign(m) for i, m in zip(idxs, msgs)]
    return [k.pub_key().bytes() for k in ks], idxs, pks, msgs, sigs


def flip(sig, seed):
    rng = np.random.default_rng(seed)
    b = bytearray(sig)
    b[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


# -- resolve_mesh ---------------------------------------------------------------


@pytest.mark.parametrize("cap", [0, 1, 4, 8])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_resolve_mesh_equals_jax(mode, cap):
    j_mesh, j_shards, j_reason = jbackend.resolve_mesh(mode, cap)
    if len(jax.devices("cpu")) != 8:
        pytest.skip("needs the conftest's 8 virtual CPU devices")
    p_mesh, p_shards, p_reason = pbackend.resolve_mesh(mode, cap, device=CPU, cpu_shards=8)
    assert (p_shards, p_reason) == (j_shards, j_reason)
    assert (p_mesh is None) == (j_mesh is None)
    if p_mesh is not None:
        assert p_mesh.size == j_mesh.devices.size == p_shards
        assert (p_mesh.AXIS,) == tuple(j_mesh.axis_names) == ("batch",)
        assert p_mesh.shape == dict(j_mesh.shape)
        assert all(d == torch.device(CPU) for d in p_mesh.devices)


def test_a_failing_probe_raises_where_jax_degrades(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device plane down")

    monkeypatch.setattr(jax, "devices", boom)
    assert jbackend.resolve_mesh("on", 8)[:2] == (None, 1)
    assert jbackend.resolve_mesh("on", 8)[2].startswith("mesh probe failed")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", boom)
    with pytest.raises(RuntimeError, match="mesh probe failed.*device plane down"):
        pbackend.resolve_mesh("on", 8)
    # "off" probes nothing in either package
    assert pbackend.resolve_mesh("off", 8) == jbackend.resolve_mesh("off", 8)


@pytest.mark.parametrize("mode, cap, want", [
    ("auto", 0, (None, "single device (cuda:2 named, 4 visible, cuda)")),
    ("on", 0, (["cuda:2", "cuda:3"], "sharded over 2/2 cuda devices from cuda:2")),
    ("on", 1, (None, "single device (2 visible from cuda:2, cuda)")),
    ("off", 0, (None, "mesh off (config)")),
])
def test_a_named_card_pins_the_mesh(mode, cap, want, monkeypatch):
    """A card named with its index is where the engine runs: "auto" keeps to
    it, "on" shards over the cards from it on, and a verifier or fold given
    that card and another card's mesh raises instead of moving onto it.  On
    4 cards that the probe sees (the CPU standing in for them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh, shards, reason = pbackend.resolve_mesh(mode, cap, device="cuda:2")
    devices, want_reason = want
    assert reason == want_reason
    assert shards == (len(devices) if devices else 1)
    assert (mesh is None) == (devices is None)
    if mesh is not None:
        assert mesh.devices == tuple(map(torch.device, devices))
        assert mesh.lead("cuda:2") == mesh.lead("cuda") == torch.device("cuda:2")
        with pytest.raises(ValueError, match="not the mesh's first device"):
            bvm.BatchVerifier(device="cuda:0", mesh=mesh)
        before = scheme._fold_device, scheme._fold_mesh
        with pytest.raises(ValueError, match="not the mesh's first device"):
            scheme.set_jax_aggregation(True, mesh=mesh, device="cuda:3")
        assert (scheme._fold_device, scheme._fold_mesh) == before
    # an unnamed card probes every card from the first, as JAX does
    assert pbackend.resolve_mesh("on", 2)[2] == "sharded over 2/4 cuda devices"
    with pytest.raises(RuntimeError, match="mesh probe failed.*cuda:5 is not one of the 4"):
        pbackend.resolve_mesh("on", 0, device="cuda:5")


def test_without_a_card_the_card_probe_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="mesh probe failed.*CUDA is not available"):
        pbackend.resolve_mesh("auto")


def test_the_mesh_type():
    mesh = pmesh(3)
    assert (mesh.size, mesh.shape) == (3, {"batch": 3})
    assert mesh.distinct() == [torch.device(CPU)]
    assert mesh.streams() == (None, None, None)
    with mesh.on_shard(2) as stream:
        assert stream is None
    with pytest.raises(ValueError, match="at least one device"):
        pbackend.Mesh([])
    with pytest.raises(ValueError, match="of one kind"):
        pbackend.Mesh([CPU, "meta"])
    with pytest.raises(ValueError, match="not the mesh's first device"):
        bvm.BatchVerifier(device="meta", mesh=mesh)
    assert mesh.lead() == mesh.lead(CPU) == torch.device(CPU)
    v = bvm.BatchVerifier(mesh=mesh)  # the mesh's first device, not the card
    assert v.device == torch.device(CPU) and v.shards == 3 and not v._needs_library
    v.start_warmup()  # nothing to build or warm on CPU shards
    assert not v._building


# -- buckets ----------------------------------------------------------------------

SIZES = [1, 2, 10, 13, 16, 17, 63, 64, 65, 100, 1000, 2047, 2048, 2049, 3000, 9999, 10000,
         10240, 10241, 20000]


@pytest.mark.parametrize("m", [1, 2, 3, 4, 6, 8])
def test_bucket_and_chunk_equal_jax(m):
    jv = jbvm.BatchVerifier(mesh=jmesh(m))
    pv = bvm.BatchVerifier(mesh=pmesh(m))
    assert [pv._bucket(n) for n in SIZES] == [jv._bucket(n) for n in SIZES]
    for cs in (0, 12, 100, 2048, 2050):
        jv.chunk_size = pv.chunk_size = cs
        assert pv.effective_chunk() == jv.effective_chunk()
    one = bvm.BatchVerifier(device=CPU)
    assert [one._bucket(n) for n in SIZES] == SIZES  # one device: no padding


# -- flat verify ----------------------------------------------------------------


@pytest.mark.parametrize("n", [10, 13, 64])
def test_flat_verify_on_8_shards_equals_jax(n):
    _, _, pks, msgs, sigs = signed(n)
    sigs[7] = bytes(64)
    sigs[n - 1] = flip(sigs[n - 1], n)
    jrec, prec = JFlightRecorder(), FlightRecorder()
    jv = jbvm.BatchVerifier(mesh=jmesh(8), recorder=jrec)
    pv = bvm.BatchVerifier(mesh=pmesh(8), recorder=prec)
    want = jv.verify(pks, msgs, sigs)
    assert want == [i not in (7, n - 1) for i in range(n)]
    assert pv.verify(pks, msgs, sigs) == want
    (jev,), (pev,) = jrec.events(kinds=["verify.dispatch"]), prec.events(kinds=["verify.dispatch"])
    assert set(pev) == set(jev)
    for k in ("n", "bucket", "path", "shards"):
        assert pev[k] == jev[k], k
    assert pev["shards"] == 8 and pev["bucket"] == jv._bucket(n) == pv.last_dispatch["bucket"]


def test_shards_on_the_verify_events():
    """The host path's dispatch, the RTT probe and the flusher's events
    carry `shards` as JAX's do."""
    _, _, pks, msgs, sigs = signed(5)
    jrec, prec = JFlightRecorder(), FlightRecorder()
    jv = jbvm.BatchVerifier(mesh=jmesh(8), recorder=jrec, min_device_batch=100)
    pv = bvm.BatchVerifier(mesh=pmesh(8), recorder=prec, min_device_batch=100)
    assert pv.verify(pks, msgs, sigs) == jv.verify(pks, msgs, sigs) == [True] * 5
    jv.probe_dispatch_rtt(samples=1)
    pv.probe_dispatch_rtt(samples=1)
    for kind in ("verify.dispatch", "verify.chunked"):
        (jev,), (pev,) = jrec.events(kinds=[kind]), prec.events(kinds=[kind])
        assert set(pev) == set(jev) and pev["shards"] == jev["shards"] == 8, kind
    assert pev["prep_ms"] > 0 and pv.rtt_probe["prep_ms_per_chunk"] > 0


# -- the indexed paths ------------------------------------------------------------


def test_sharded_indexed_equals_jax_sharded_and_one_device():
    keys, idxs, _, msgs, sigs = signed(64)
    sigs[5] = bytes(64)  # garbage
    sigs[33] = flip(sigs[33], 33)
    msgs[50] = b"forged"
    idxs[60] = 999  # out of range
    want = [i not in (5, 33, 50, 60) for i in range(64)]
    got = {
        "jax mesh": jbvm.PubkeyTable(keys, jbvm.BatchVerifier(mesh=jmesh(8))),
        "jax one": jbvm.PubkeyTable(keys, jbvm.BatchVerifier()),
        "port mesh": bvm.PubkeyTable(keys, bvm.BatchVerifier(mesh=pmesh(8))),
        "port one": bvm.PubkeyTable(keys, bvm.BatchVerifier(device=CPU)),
    }
    got = {k: t.verify_indexed(idxs, msgs, sigs) for k, t in got.items()}
    assert got == dict.fromkeys(got, want)


def test_liar_on_every_shard_through_jax_rows():
    """One invalid signature at each of the 8 shards' slices: the port's
    table, carried over from JAX's replicated rows, blames exactly those
    rows, as JAX's sharded table does."""
    keys, idxs, _, msgs, sigs = signed(64)
    liars = [shard * 8 + 3 for shard in range(8)]
    for j in liars:
        sigs[j] = bytes(64)
    jtab = jbvm.PubkeyTable(keys, jbvm.BatchVerifier(mesh=jmesh(8)))
    want = jtab.verify_indexed(idxs, msgs, sigs)
    assert want == [i not in liars for i in range(64)]
    ptab = bvm.from_jax_state(np.asarray(jtab.neg_a_rows), None, device=CPU, mesh=pmesh(8))
    assert ptab.verifier.shards == 8 and ptab.tabulated is None
    assert set(ptab._replicas) == {torch.device(CPU)}
    assert ptab.verify_indexed(idxs, msgs, sigs) == want
    d = ptab.verifier.last_dispatch
    assert (d["path"], d["bucket"], d["shards"]) == ("indexed", 64, 8)


def test_forced_chunked_with_a_chunk_size_8_does_not_divide(monkeypatch):
    """_CHUNK = 12 rounds to 16 on 8 shards; 35 signatures make two full
    chunks and a last one of 3, padded to 16 (shards 2-7 all padding)."""
    monkeypatch.setattr(jbvm, "_CHUNK", 12)
    monkeypatch.setattr(bvm, "_CHUNK", 12)
    keys, idxs, _, msgs, sigs = signed(35)
    bad = (3, 20, 33)
    for j in bad:
        sigs[j] = flip(sigs[j], j)
    jtab = jbvm.PubkeyTable(keys, jbvm.BatchVerifier(mesh=jmesh(8)))
    ptab = bvm.PubkeyTable(keys, bvm.BatchVerifier(mesh=pmesh(8), chunk_depth=2))
    jtab.chunked_single_shot = ptab.chunked_single_shot = True
    assert ptab.verifier.effective_chunk() == jtab.verifier.effective_chunk() == 16
    want = jtab.verify_indexed(idxs, msgs, sigs)
    assert want == [i not in bad for i in range(35)]
    assert ptab.verify_indexed(idxs, msgs, sigs) == want
    d = ptab.verifier.last_dispatch
    assert (d["path"], d["bucket"], d["shards"]) == ("chunked", 16, 8)


def test_forced_tabulated_runs_unsharded_and_auto_is_off(monkeypatch):
    """Under a mesh AUTO resolves to the ladder; a forced tabulated table
    runs unsharded on the mesh's first device and records the mesh's
    shards (JAX :1028-1060)."""
    keys, idxs, _, msgs, sigs = signed(4, keys=4)
    mesh = pmesh(4)
    assert bvm.PubkeyTable(keys, bvm.BatchVerifier(mesh=mesh))._auto_tabulated(4) is False
    tab = bvm.PubkeyTable(keys, bvm.BatchVerifier(mesh=mesh), tabulated=True)
    calls = []
    from tendermint_tpu_torch.ops import ed25519_table

    real = ed25519_table.verify_tabulated
    monkeypatch.setattr(ed25519_table, "verify_tabulated",
                        lambda *a, **k: (calls.append(a[1].shape[0]), real(*a, **k))[1])
    assert tab.verify_indexed(idxs, msgs, sigs) == [True] * 4
    d = tab.verifier.last_dispatch
    assert (d["path"], d["bucket"], d["shards"], calls) == ("tabulated", 4, 4, [4])


# -- the sharded fold -----------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 3, 4, 6, 8])
def test_mesh_bucket_equals_jax(m):
    jm, pm = jmesh(m), pmesh(m)
    for n in list(range(1, 40)) + [100, 1000, 10000]:
        jb, jsh = jax_tier._mesh_bucket(n, jm)
        pb, psh = cuda_tier._mesh_bucket(n, pm)
        assert (pb, psh is None) == (jb, jsh is None), n
        assert psh is None or psh is pm
    assert cuda_tier._mesh_bucket(5, None) == jax_tier._mesh_bucket(5, None) == (8, None)


GROUPS = {
    "g1": (curve.g1_mul, curve.G1_GEN, curve.G1_INF, curve.g1_add, curve.g1_neg,
           jax_tier.aggregate_g1, cuda_tier.aggregate_g1),
    "g2": (curve.g2_mul, curve.G2_GEN, curve.G2_INF, curve.g2_add, curve.g2_neg,
           jax_tier.aggregate_g2, cuda_tier.aggregate_g2),
}


def fold_points(group, n):
    """n seeded multiples of the generator; with n > 8 a doubling at level 0
    (rows 0 and 1) and P + (-P) (rows 6 and 7)."""
    mul, gen, _, _, neg = GROUPS[group][:5]
    ks = np.random.default_rng(SEED).integers(1, 1 << 62, n)
    pts = [mul(gen, int(k)) for k in ks]
    if n > 8:
        pts[1] = pts[0]
        pts[7] = neg(pts[6])
    return pts


@pytest.mark.parametrize("case", ["3 points on 4 shards", "100 points on 4 shards",
                                  "3 points on 3 shards"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_sharded_fold_equals_jax(group, case):
    n, m = {"3 points on 4 shards": (3, 4), "100 points on 4 shards": (100, 4),
            "3 points on 3 shards": (3, 3)}[case]
    _, _, inf, add, _, jfold, pfold = GROUPS[group]
    pts = fold_points(group, n)
    want = jfold(pts, mesh=jmesh(m))
    assert want is not None
    assert pfold(pts, mesh=pmesh(m)) == want
    assert pfold(pts, device=CPU) == want  # the one-device fold: the same association
    acc = inf
    for p in pts:
        acc = add(acc, p)
    assert curve.g1_eq(acc, want) if group == "g1" else curve.g2_eq(acc, want)


def test_one_point_shards_fold_without_a_launch_of_their_own(monkeypatch):
    """3 points on 4 shards: bucket 4, one row a shard, so the shards fold
    nothing and the root folds the four rows (the fourth the identity)."""
    from tendermint_tpu_torch.ops import bls12_381_fold

    buckets = []
    real = bls12_381_fold.fold_g1
    monkeypatch.setattr(bls12_381_fold, "fold_g1",
                        lambda rows: (buckets.append(rows.shape[0]), real(rows))[1])
    pts = fold_points("g1", 3)
    assert cuda_tier.aggregate_g1(pts, mesh=pmesh(4)) == cuda_tier.aggregate_g1(pts, device=CPU)
    assert buckets == [4, 4]  # the root of the sharded fold, then the one-device fold
    buckets.clear()
    cuda_tier.aggregate_g1(fold_points("g1", 100), mesh=pmesh(4))
    assert buckets == [32, 32, 32, 32, 4]
