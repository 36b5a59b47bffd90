"""The port's plain field and curve layers (tendermint_tpu_torch/ops/fe.py,
ops/curve.py) against the JAX package's (tendermint_tpu/ops/fe.py,
ops/curve.py) and against Python ints.

Integer math throughout: limbs must be bit-identical (tolerance 0).
Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto import ed25519_math as jem
from tendermint_tpu.ops import curve as jcurve
from tendermint_tpu.ops import fe as jfe
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.ops import curve, fe

# B <= 16: intra-op threads buy nothing here and contend with other test workers
torch.set_num_threads(1)

P = em.P
SPECIALS = [0, 1, 19, P - 1, P - 19, 2**255 - 20, em.L, 2**254 + 12345]


def _lanes(ints):
    """[20, n] int32 limbs, one lane per value."""
    arr = np.zeros((fe.N_LIMBS, len(ints)), np.int32)
    for lane, v in enumerate(ints):
        arr[:, lane] = fe.from_int(v)[:, 0]
    return arr


def _rand_ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _both(arr):
    return torch.as_tensor(arr), jnp.asarray(arr)


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _ints(arr):
    arr = arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return [fe.to_int(arr, lane) for lane in range(arr.shape[1])]


def test_constants_match():
    np.testing.assert_array_equal(fe.BIAS_64P, jfe.BIAS_64P)
    np.testing.assert_array_equal(fe.P_LIMBS, jfe.P_LIMBS)
    assert (fe.FOLD, fe.FOLD2, fe.N_LIMBS, fe.LIMB_BITS) == (
        jfe.FOLD, jfe.FOLD2, jfe.N_LIMBS, jfe.LIMB_BITS)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "square"])
def test_field_op_bit_identical_and_exact(op):
    rng = np.random.default_rng(100)
    vals = SPECIALS + _rand_ints(rng, 24)
    rev = list(reversed(vals))
    a_np, b_np = _lanes(vals), _lanes(rev)
    # limbs at the invariant's ceiling (10016) exercise the int32 bounds
    a_np[:, 0] = 10016
    b_np[:, 1] = 10016
    ta, ja = _both(a_np)
    tb, jb = _both(b_np)
    if op == "square":
        got_t, got_j = fe.square(ta), jfe.square(ja)
    else:
        got_t, got_j = getattr(fe, op)(ta, tb), getattr(jfe, op)(ja, jb)
    _same(got_t, got_j)
    assert got_t.dtype == torch.int32
    a_int, b_int = _ints(a_np), _ints(b_np)
    expect = {
        "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
        "mul": lambda x, y: x * y, "square": lambda x, y: x * x,
    }[op]
    assert [v % P for v in _ints(got_t)] == [expect(x, y) % P for x, y in zip(a_int, b_int)]


def test_canonical_bit_identical_and_reduced():
    rng = np.random.default_rng(101)
    arr = rng.integers(0, 10017, size=(fe.N_LIMBS, 32)).astype(np.int32)
    arr[:, :len(SPECIALS)] = _lanes(SPECIALS)
    arr[:, -1] = fe.MASK  # 2^260 - 1, above 2p
    arr[:, -2] = _lanes([P + 5])[:, 0]
    t, j = _both(arr)
    got = curve.canonical(t)
    _same(got, jcurve.canonical(j))
    _same(fe.canonical(t), jfe.canonical(j))
    assert _ints(got) == [v % P for v in _ints(arr)]


def test_invert_bit_identical():
    vals = [2, 12345678901234567890, P - 2, 19]
    t, j = _both(_lanes(vals))
    got = fe.invert(t)
    _same(got, jfe.invert(j))
    assert [v * inv % P for v, inv in zip(vals, _ints(curve.canonical(got)))] == [1] * 4


def _points(rng, n):
    """n random curve points (extended, Z=1) as Python tuples."""
    pts = []
    while len(pts) < n:
        aff = em.decompress(rng.bytes(32))
        if aff is not None:
            pts.append(em.to_extended(*aff))
    return pts


def _point_lanes(pts):
    return tuple(_lanes([p[c] for p in pts]) for c in range(4))


def _affine(point, lane):
    x, y, z, _ = (fe.to_int(curve.canonical(c), lane) for c in point)
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def test_point_ops_bit_identical_and_on_curve():
    rng = np.random.default_rng(102)
    p_py, q_py = _points(rng, 6), _points(rng, 6)
    p_np, q_np = _point_lanes(p_py), _point_lanes(q_py)
    tp = tuple(torch.as_tensor(c) for c in p_np)
    tq = tuple(torch.as_tensor(c) for c in q_np)
    jp = tuple(jnp.asarray(c) for c in p_np)
    jq = tuple(jnp.asarray(c) for c in q_np)
    two_d = fe.from_int(2 * em.D % P)
    t2d, j2d = torch.as_tensor(two_d), jnp.asarray(two_d)

    added = curve.point_add(tp, tq, t2d)
    doubled = curve.point_double(tp)
    for got, want in zip(added, jcurve.point_add(jfe, jp, jq, j2d)):
        _same(got, want)
    for got, want in zip(doubled, jcurve.point_double(jfe, jp)):
        _same(got, want)

    # madd against the affine madd form of q
    madd_np = tuple(
        _lanes([f(q) for q in q_py]) for f in (
            lambda q: (q[1] - q[0]) % P, lambda q: (q[1] + q[0]) % P,
            lambda q: 2 * em.D * q[0] % P * q[1] % P)
    )
    madded = curve.point_madd(tp, tuple(torch.as_tensor(c) for c in madd_np))
    for got, want in zip(madded, jcurve.point_madd(jfe, jp, tuple(jnp.asarray(c) for c in madd_np))):
        _same(got, want)

    for lane, (p, q) in enumerate(zip(p_py, q_py)):
        want = em.to_affine(em.point_add(p, q))
        assert _affine(added, lane) == want
        assert _affine(madded, lane) == want
        assert _affine(doubled, lane) == em.to_affine(em.point_double(p))


def test_select_and_neg_a_table_bit_identical():
    rng = np.random.default_rng(103)
    pts = _points(rng, 4)
    a_np = _point_lanes(pts)
    ident_np = tuple(np.broadcast_to(c, (fe.N_LIMBS, 4)).copy() for c in (
        fe.from_int(0), fe.from_int(1), fe.from_int(1), fe.from_int(0)))
    two_d = fe.from_int(2 * em.D % P)
    ttab = curve.neg_a_table(tuple(torch.as_tensor(c) for c in a_np),
                             tuple(torch.as_tensor(c) for c in ident_np), torch.as_tensor(two_d))
    jtab = jcurve.neg_a_table(jfe, tuple(jnp.asarray(c) for c in a_np),
                              tuple(jnp.asarray(c) for c in ident_np), jnp.asarray(two_d))
    for tp, jp in zip(ttab, jtab):
        for got, want in zip(tp, jp):
            _same(got, want)
    for lane, p in enumerate(pts):
        assert _affine(ttab[13], lane) == em.to_affine(em.scalar_mult(13, p))

    digits = rng.integers(0, 16, 4).astype(np.int32)
    sel = curve.select_point(ttab, torch.as_tensor(digits))
    jsel = jcurve.select_point(jtab, jnp.asarray(digits))
    for got, want in zip(sel, jsel):
        _same(got, want)
    trip = [tuple(p[:3]) for p in ttab]
    jtrip = [tuple(p[:3]) for p in jtab]
    for got, want in zip(curve.select_triplet(trip, torch.as_tensor(digits)),
                         jcurve.select_triplet(jtrip, jnp.asarray(digits))):
        _same(got, want)


def test_oracle_copy_matches_jax_oracle():
    """The port keeps its own copy of the pure-Python oracle."""
    rng = np.random.default_rng(104)
    for _ in range(8):
        data = rng.bytes(32)
        assert em.decompress(data) == jem.decompress(data)
    assert (em.P, em.L, em.D, em.BASE) == (jem.P, jem.L, jem.D, jem.BASE)
