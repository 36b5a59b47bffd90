"""The batched BLS12-381 point fold (tendermint_tpu_torch/crypto/bls/cuda_tier.py,
ops/bls12_381_fold.py, csrc/bls12_381_fold.cu) against the JAX package's
jax_tier and the pure fold (curve.g1_add / g2_add one point after another).
Points are multiples of the generators by scalars drawn with seeded numpy.
Tolerance 0: Jacobian triples and rows limb for limb, compressed points
byte for byte, commit bytes and verdicts exactly.

- Against JAX: cuda_tier.aggregate_g1/g2 on the CPU (the kernels' plain
  version) return jax_tier.aggregate_g1/g2's Jacobian triple at bucket 8,
  for n = 5 and 8 with the edge rows (a doubling, P + (-P), the identity on
  either side); each JAX group compiles once for the module.
- The host prep: the rows equal the arrays jax_tier builds.
- Against the pure fold at n = 1, 2, 7, 9, 33 and 100, and on an edge mix
  (every row but one at infinity, doublings, opposites).
- The wrappers: a CPU tensor takes the plain version and counts no launch;
  a bucket that is no power of two >= 2 raises.
- The fold's plan: the kernels' association (fold_plain on each aligned
  subtree of a tier, then on the block sums) at subtrees of 4 and 8
  points, buckets 2-64 in 1-3 tiers, equals fold_plain whole limb for limb
  and the pure fold as compressed points; plan() itself.
- Routing: with the knob on, 7 points fold on the host and 8 through the
  fold; the C lanes never reach it.
- The slice: on an 8-validator uniformly BLS set under a forced pure tier,
  with the knob on in both packages, fold_commit, verify_commit and
  batch_verify_aggregates (a corrupted aggregate among three) give the same
  bytes and verdicts in the port as in JAX, and each fold ran.
- The mesh: `set_jax_aggregation` takes one, and the scheme's sums of 8
  points sharded over 4 CPU shards and unsharded on a 3-shard mesh equal
  JAX's scheme with its 3-device mesh (unsharded at the bucket of 8 this
  module compiles) and the pure fold.
- Refusals: the card is required unless the CPU is named.
- A port node with `[tpu] bls_jax_aggregation = true` starts on the CPU and
  installs the fold on its device.
- chip_smoke.py's fold phases rehearsed on the CPU at small sizes: phase
  2's fold checks, the work phase 22's bound counts, and phase 22 (the fold
  at size, then the aggregate-commit paths' pure lanes through the fold
  against the C tier).
"""

import os

import numpy as np
import pytest
import torch

import tendermint_tpu.crypto.bls.ctier as jctier
import tendermint_tpu.crypto.bls.jax_tier as jax_tier
import tendermint_tpu.crypto.bls.scheme as jscheme
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.crypto.bls import ctier as pctier
from tendermint_tpu_torch.crypto.bls import cuda_tier, curve
from tendermint_tpu_torch.crypto.bls import scheme as pscheme
from tendermint_tpu_torch.ops import bls12_381_fold as fold

import test_torch_agg_commit as agg
from test_torch_node import PORT as NODE_PORT
from test_torch_node import load_cfg, make_home, until

torch.set_num_threads(1)

SEED = 2222
G1 = (curve.g1_mul, curve.G1_GEN, curve.G1_INF, curve.g1_add, curve.g1_neg, curve.g1_compress)
G2 = (curve.g2_mul, curve.G2_GEN, curve.G2_INF, curve.g2_add, curve.g2_neg, curve.g2_compress)
GROUPS = {"g1": G1, "g2": G2}


def points(group, n, seed=SEED):
    """n points k·G with seeded 62-bit k: Jacobian, general Z."""
    mul, gen = GROUPS[group][:2]
    ks = np.random.default_rng(seed).integers(1, 1 << 62, n)
    return [mul(gen, int(k)) for k in ks]


def edge(group, n):
    """[P, P, Q, -Q, R, inf, inf, S] + more: at level 0 a doubling, P + (-P)
    (the all-zero point), R + inf and inf + S; cut to n."""
    inf, neg = GROUPS[group][2], GROUPS[group][4]
    p, q, r, s, *more = points(group, 4 + max(0, n - 8), seed=SEED + 1)
    return ([p, p, q, neg(q), r, inf, inf, s] + more)[:n]


def pure_sum(group, pts):
    inf, add = GROUPS[group][2], GROUPS[group][3]
    acc = inf
    for p in pts:
        acc = add(acc, p)
    return acc


def port_sum(group, pts):
    fn = cuda_tier.aggregate_g1 if group == "g1" else cuda_tier.aggregate_g2
    return fn(pts, device="cpu")


@pytest.fixture
def restored():
    """Both schemes' fold knob, both C tiers' forcing and both memos as
    they were."""
    yield
    for scheme, ctier in ((pscheme, pctier), (jscheme, jctier)):
        scheme.set_jax_aggregation(False)
        ctier.set_forced(None)
        scheme._memo.clear()


# -- against JAX -------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_aggregate_equals_jax_tier(group, n):
    pts = edge(group, n)
    want = (jax_tier.aggregate_g1 if group == "g1" else jax_tier.aggregate_g2)(pts)
    assert want is not None
    assert port_sum(group, pts) == want


@pytest.mark.parametrize("n", [5, 8, 33])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_rows_equal_the_arrays_jax_tier_builds(group, n, monkeypatch):
    seen = []

    def capture(bucket, mesh=None, batch_axis="batch"):
        fn = lambda rows: (seen.append(np.array(rows)), np.zeros(rows.shape[1:], np.int32))[1]
        return fn, fn

    monkeypatch.setattr(jax_tier, "_get_fns", capture)
    pts = edge(group, n) if n <= 8 else points(group, n)
    assert (jax_tier.aggregate_g1 if group == "g1" else jax_tier.aggregate_g2)(pts) is not None
    rows = (cuda_tier.g1_rows if group == "g1" else cuda_tier.g2_rows)(pts)
    assert rows.dtype == seen[0].dtype == np.int32
    np.testing.assert_array_equal(rows, seen[0])
    assert rows.shape[0] == jax_tier._mesh_bucket(n, None)[0] == cuda_tier._bucket(n)


def test_constants_equal_jax_tier():
    assert (cuda_tier.NL, cuda_tier.RADIX, cuda_tier.MASK, cuda_tier.MIN_BATCH, cuda_tier._R) == (
        jax_tier.NL, jax_tier.RADIX, jax_tier.MASK, jax_tier.MIN_BATCH, jax_tier._R)
    for x in (0, 1, 12345, curve.P - 1):
        assert cuda_tier._from_mont(cuda_tier._to_mont(x)) == jax_tier._from_mont(
            jax_tier._to_mont(x)) == x
        np.testing.assert_array_equal(cuda_tier._int_to_limbs(x), jax_tier._int_to_limbs(x))
    assert [cuda_tier._bucket(n) for n in (1, 2, 3, 8, 9, 10_000)] == [2, 2, 4, 8, 16, 16384]


# -- against the pure fold ---------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 9, 33, 100])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_fold_equals_the_pure_fold(group, n):
    pts = points(group, n)
    compress = GROUPS[group][5]
    assert compress(port_sum(group, pts)) == compress(pure_sum(group, pts))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_fold_on_an_edge_mix(group):
    inf = GROUPS[group][2]
    compress = GROUPS[group][5]
    (p,) = points(group, 1, seed=SEED + 2)
    for pts in (edge(group, 8), edge(group, 9), edge(group, 33), [inf] * 8 + [p],
                [p] + [inf] * 8, [inf] * 9, [p, GROUPS[group][4](p)]):
        got = port_sum(group, pts)
        want = pure_sum(group, pts)
        assert compress(got) == compress(want)
    # the identity comes back as the all-zero point, as from jax_tier
    assert port_sum(group, [inf] * 9) == inf


def test_wrappers_take_the_plain_version_on_the_cpu_and_check_the_bucket():
    rows1 = torch.as_tensor(cuda_tier.g1_rows(points("g1", 3)))
    rows2 = torch.as_tensor(cuda_tier.g2_rows(points("g2", 3)))
    before = (fold.G1_LAUNCHES, fold.G2_LAUNCHES)
    assert torch.equal(fold.fold_g1(rows1), fold.fold_plain(rows1))
    assert torch.equal(fold.fold_g2(rows2), fold.fold_plain(rows2))
    assert fold.fold_g1(rows1).shape == (3, 48) and fold.fold_g2(rows2).shape == (3, 2, 48)
    assert (fold.G1_LAUNCHES, fold.G2_LAUNCHES) == before
    for bad in (rows1[:3], rows1[:1]):
        with pytest.raises(ValueError, match="power-of-two bucket"):
            fold.fold_g1(bad)


# -- the fold's plan ------------------------------------------------------------


def fold_by_plan(rows: torch.Tensor, leaves: int) -> torch.Tensor:
    """The kernels' association on the CPU: each tier of fold.plan (every
    block `leaves` points) folds its aligned subtrees (fold_plain on each),
    the next one the block sums."""
    cur = rows
    for per, blocks in fold.plan(rows.shape[0], leaves, leaves):
        cur = torch.stack([fold.fold_plain(cur[b * per:(b + 1) * per]) for b in range(blocks)])
    assert cur.shape[0] == 1
    return cur[0]


def plan_case(group, kind, leaves):
    """Points for a plan case: `n` seeded points (every other one a sum of
    two, so Z != 1), the edge rows, or a seam of the plan at `leaves`: 2L
    copies of one point, halves summing to S and -S, the live rows in the
    last subtree."""
    inf, add, neg = GROUPS[group][2], GROUPS[group][3], GROUPS[group][4]
    pts = points(group, 9, seed=SEED + 3)
    mixed = [add(p, q) if i % 2 else p for i, (p, q) in enumerate(zip(pts, pts[1:] + pts[:1]))]
    if kind == "copies":
        return [mixed[1]] * (2 * leaves)
    if kind == "opposite halves":
        half = (mixed + [inf] * leaves)[:leaves]
        return half + [neg(p) for p in half]
    if kind == "last subtree":
        return [inf] * leaves + mixed[:leaves]
    if kind == "edge":
        return edge(group, 8)
    return (mixed * 8)[:kind]


PLAN_CASES = [(4, 2, 1), (4, 3, 1), (4, 9, 2), (4, 33, 3), (8, 5, 1), (8, 17, 2), (8, 33, 2),
              (4, "edge", 2), (4, "copies", 2), (4, "opposite halves", 2),
              (8, "last subtree", 2)]


@pytest.mark.parametrize("leaves,kind,tiers", PLAN_CASES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_the_plan_keeps_the_association(group, leaves, kind, tiers):
    pts = plan_case(group, kind, leaves)
    rows = torch.as_tensor((cuda_tier.g1_rows if group == "g1" else cuda_tier.g2_rows)(pts))
    assert len(fold.plan(rows.shape[0], leaves, leaves)) == tiers
    got = fold_by_plan(rows, leaves)
    assert torch.equal(got, fold.fold_plain(rows))
    point = (cuda_tier.g1_point if group == "g1" else cuda_tier.g2_point)(got)
    compress = GROUPS[group][5]
    assert compress(point) == compress(pure_sum(group, pts))


def test_the_plan():
    assert (fold.LEAVES, fold.TIER_LEAVES) == (128, 16)
    assert fold.plan(16384) == [(128, 128), (16, 8), (8, 1)]  # 10,000 points
    assert fold.plan(1024) == [(128, 8), (8, 1)]
    assert fold.plan(128) == [(128, 1)] and fold.plan(8) == [(8, 1)] and fold.plan(2) == [(2, 1)]
    assert fold.plan(1 << 21) == [(128, 16384), (16, 1024), (16, 64), (16, 4), (4, 1)]
    assert fold.plan(64, 4, 4) == [(4, 16), (4, 4), (4, 1)] and fold.plan(64, 4) == [(4, 16), (16, 1)]
    for bucket in (2, 8, 1024, 16384, 1 << 20):
        steps = fold.plan(bucket)
        assert steps[0][0] * steps[0][1] == bucket
        assert all(a[1] == b[0] * b[1] for a, b in zip(steps, steps[1:])) and steps[-1][1] == 1
    for bad in (1, 3, 6):
        with pytest.raises(ValueError, match="power-of-two count"):
            fold.plan(16, bad)
        with pytest.raises(ValueError, match="power-of-two count"):
            fold.plan(16, 4, bad)
    with pytest.raises(ValueError, match="power-of-two bucket"):
        fold.plan(12)


# -- routing -----------------------------------------------------------------


def test_seven_points_fold_on_the_host_and_eight_through_the_fold(restored, monkeypatch):
    calls = []
    real = cuda_tier.aggregate_g1
    monkeypatch.setattr(cuda_tier, "aggregate_g1",
                        lambda pts, **kw: calls.append(len(pts)) or real(pts, **kw))
    sks = [pscheme.keygen(bytes([i + 1]) * 32) for i in range(8)]
    pks = [pscheme.sk_to_pk(sk) for sk in sks]
    c_tier = [pscheme.aggregate_pubkeys(pks[:n]) for n in (7, 8)]
    pscheme.set_jax_aggregation(True, device="cpu")
    assert c_tier == [pscheme.aggregate_pubkeys(pks[:n]) for n in (7, 8)]
    assert calls == []  # the C lanes never reach the fold
    pctier.set_forced("pure")
    assert pscheme.active_tier() == "pure"
    assert [pscheme.aggregate_pubkeys(pks[:n]) for n in (7, 8)] == c_tier
    assert calls == [8]


# -- the slice as a whole ------------------------------------------------------


def _slice(ns, counted):
    """fold_commit, verify_commit and batch_verify_aggregates on an
    8-validator uniformly BLS set: its commits are made on the C tier,
    then everything runs on the pure tier with the fold on."""
    vset, pvs = agg.bls_set(ns, 8, tag=b"fold")
    bid = agg.block_id(ns)
    commits = [agg.make_commit(ns, vset, pvs, h, 0, bid) for h in (3, 4, 5)]
    folded_c = [ns.agg.fold_commit(c, vset, agg.CHAIN) for c in commits]
    ctier = pctier if ns is agg.PORT else jctier
    ctier.set_forced("pure")
    ns.scheme.set_jax_aggregation(True, **({"device": "cpu"} if ns is agg.PORT else {}))
    folded = ns.agg.fold_commit(commits[0], vset, agg.CHAIN)
    vset.verify_commit(agg.CHAIN, bid, 3, folded)
    pks = [v.pub_key.bytes() for v in vset.validators]
    items = [(pks, f.sign_message(agg.CHAIN), f.agg_sig) for f in folded_c]
    bad = folded_c[1].agg_sig[:-1] + bytes([folded_c[1].agg_sig[-1] ^ 1])
    items[1] = (pks, items[1][1], bad)
    ns.scheme._memo.clear()
    verdicts = ns.scheme.batch_verify_aggregates(items)
    return ([agg.wire(f) for f in folded_c], agg.wire(folded), verdicts, counted[:])


def test_slice_through_the_fold_equals_jax(restored, monkeypatch):
    got = {}
    for ns, tier in ((agg.JAX, jax_tier), (agg.PORT, cuda_tier)):
        counted = []
        for name in ("aggregate_g1", "aggregate_g2"):
            real = getattr(tier, name)
            monkeypatch.setattr(tier, name, lambda pts, _r=real, _n=name, **kw: (
                counted.append((_n, len(pts))), _r(pts, **kw))[1])
        got[ns.name] = _slice(ns, counted)
    c_wire, folded, verdicts, counted = got["port"]
    assert folded == c_wire[0]  # the pure tier's fold through the kernel = the C tier's
    assert verdicts == [True, False, True]
    assert ("aggregate_g2", 8) in counted and ("aggregate_g1", 8) in counted
    assert got["port"] == got["jax"]


# -- refusals and the node -----------------------------------------------------


def test_a_mesh_is_refused_naming_roadmap_2_2(restored, monkeypatch):
    """The mesh that ROADMAP 2.2 once refused is taken: the pure lanes'
    sums fold over it, and equal JAX's scheme folding over its mesh.  A
    power-of-two mesh shards the fold; a 3-shard mesh folds unsharded on
    its first device in both packages."""
    import jax
    from jax.sharding import Mesh as JMesh

    from tendermint_tpu_torch.crypto.backend import Mesh

    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices (conftest XLA_FLAGS)")
    jscheme.set_jax_aggregation(True, mesh=JMesh(np.array(devs[:3]), ("batch",)))
    for group, sum_of in (("g1", "_sum_g1"), ("g2", "_sum_g2")):
        pts = points(group, 8)
        want = getattr(jscheme, sum_of)(pts)
        assert GROUPS[group][5](want) == GROUPS[group][5](pure_sum(group, pts))
        for m in (4, 3):
            mesh = Mesh(["cpu"] * m)
            pscheme.set_jax_aggregation(True, mesh=mesh, device="cpu")
            assert pscheme._fold_mesh is mesh and pscheme._fold_device == torch.device("cpu")
            seen = []
            real = getattr(cuda_tier, f"aggregate_{group}")
            monkeypatch.setattr(cuda_tier, f"aggregate_{group}", lambda p, _r=real, **kw: (
                seen.append(kw["mesh"]), _r(p, **kw))[1])
            assert getattr(pscheme, sum_of)(pts) == want  # Jacobian, limb for limb
            assert seen == [mesh]
            monkeypatch.setattr(cuda_tier, f"aggregate_{group}", real)
    pscheme.set_jax_aggregation(False)
    assert pscheme._fold_device is None and pscheme._fold_mesh is None


def test_the_card_is_required_unless_the_cpu_is_named(restored):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pscheme.set_jax_aggregation(True)
    assert pscheme._fold_device is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_tier.aggregate_g1(points("g1", 8))
    assert cuda_tier.available() is False
    assert cuda_tier.aggregate_g1([]) is None and cuda_tier.aggregate_g2([]) is None


async def test_a_node_with_the_knob_installs_the_fold_on_its_device(tmp_path, restored):
    home = str(tmp_path / "h")
    make_home(NODE_PORT, home)
    cfg = load_cfg(NODE_PORT, home)
    cfg.tpu.bls_jax_aggregation = True
    pnode.check_ported(cfg)
    node = pnode.default_new_node(cfg, device="cpu")
    assert pscheme._fold_device is None  # construction installs nothing
    await node.start()
    try:
        assert pscheme._fold_device == torch.device("cpu") == node.device
        await until(lambda: node.block_store.height() >= 1, "the node's first block")
    finally:
        await node.stop()
        from tendermint_tpu_torch.crypto import batch as batch_hook

        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)


# -- chip_smoke.py's fold phases, rehearsed -----------------------------------


@pytest.fixture
def cs(monkeypatch):
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_phase2_fold_checks_rehearsed_on_cpu(cs, monkeypatch):
    monkeypatch.setattr(cs, "FOLD_SIZES", (8, 9))
    monkeypatch.setattr(fold, "LEAVES", 4)  # the seams at 8 points, in two tiers
    cases = [(kind, len(pts)) for kind, pts in cs.fold_cases("bls12_381_fold_g1", points("g1", 9))]
    assert cases[-3:] == [("8 copies of one point", 8), ("halves summing to S and -S", 8),
                          ("4 at infinity, then 4 points", 8)]
    report = {n: {"launches": 0} for n in cs.KERNELS}
    cs.phase_fold_kernels(report, torch.device("cpu"))
    assert [report[n]["max_abs_err"] for n in cs.FOLD_KERNELS] == [0.0, 0.0]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fold_work_counts_what_the_data_needs(cs, group):
    """phase 22 (a)'s bound counts the pairs of the kernels' tree: on the
    edge rows [P, P, Q, -Q, R, inf, inf, S] one doubling (P, P) and three
    additions ((Q, -Q), (R, S), (2P, R + S)); pairs with the identity
    need nothing."""
    name = "bls12_381_fold_" + group
    compress = cs.fold_group(name)[6]
    rows = edge(group, 8)
    total, adds, doubles = cs.fold_work(name, rows)
    assert (adds, doubles) == (3, 1)
    add, acc = GROUPS[group][3], GROUPS[group][2]
    for p in rows:  # the pure fold, one point after another
        acc = add(acc, p)
    assert compress(total) == compress(acc)
    mul, sqr = (900, 600) if group == "g2" else (300, 234)
    assert cs.fold_products(name, adds, doubles) == 3 * (12 * mul + 4 * sqr) + 8 * mul + 7 * sqr
    assert cs.fold_work(name, [rows[0]])[1:] == (0, 0)


def test_phase22_rehearsed_on_cpu(cs, monkeypatch, restored):
    monkeypatch.setattr(cs, "FOLD_POINTS", 24)
    monkeypatch.setattr(cs, "FOLD_SET", 12)
    out = cs.phase_fold("cpu", torch.device("cpu"))
    assert set(out["rows"]) == set(cs.FOLD_KERNELS)
    for name, row in out["rows"].items():
        assert row["max_abs_err"] == 0.0 and row["bucket"] == 32 and row["bound_by"] == "operations"
        # 24 distinct points: 23 additions of distinct finite points, no doubling
        assert (row["additions"], row["doublings"]) == (23, 0)
        assert row["products"] == cs.fold_products(name, 23, 0) == 23 * (
            12 * 900 + 4 * 600 if name.endswith("g2") else 12 * 300 + 4 * 234)
    # (b): fold_commit's one G2 fold; verify_commit's G1 fold and three more
    # in batch_verify_aggregates (its first claim is the scheme's memo's)
    assert out["parts"]["g2 kernel"][0] == 1 and out["parts"]["g1 kernel"][0] == 4
    assert out["parts"]["pairing"][0] == 5  # verify, the product, three per-claim checks
    assert out["launches"] == dict.fromkeys(cs.KERNELS, 0)  # no card here
    assert pscheme._fold_device is None and pscheme.active_tier() == "c"
