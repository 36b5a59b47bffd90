"""The batched BLS12-381 point fold: the sum of a bucket of Jacobian G1 or
G2 points as a binary tree of complete point additions.

Rows come in the JAX package's layout (crypto/bls/cuda_tier.py builds them
as tendermint_tpu/crypto/bls/jax_tier.py does): every Fp element is 48
8-bit limbs in int32, in Montgomery form with R = 2^384; a G1 point is
[3, 48] (X, Y, Z), a G2 point [3, 2, 48] (each coordinate c0 + c1·u); the
identity is the all-zero row (Z = 0).  The bucket is a power of two >= 2.

    fold_g1(rows [bucket, 3, 48] int32)    -> [3, 48] int32
    fold_g2(rows [bucket, 3, 2, 48] int32) -> [3, 2, 48] int32

The tree keeps jax_tier._tree's association: at level s the point at i,
where i % 2^(s+1) == 0, becomes cur[i] + cur[i + 2^s], the lower index on
the left, and the result is row 0.  The point addition is jax_tier's
_make_point_add: add-2007-bl and dbl-2009-l both computed, small multiples
by repeated addition, every field result canonical (< P), then per lane
Z1 = 0 gives Q, Z2 = 0 gives P, the same x and y the double, the same x
alone the all-zero point.  With the same association and formulas every
output limb equals JAX's.

On CUDA tensors `fold_g1` / `fold_g2` launch a kernel of
csrc/bls12_381_fold.cu once a fold, by the tiers of `plan(bucket)`: the
blocks of the first tier fold aligned subtrees of LEAVES points each, and
the block that completes a group of TIER_LEAVES block sums folds them in
the next tier, until one sum is left (at 10,000 points, bucket 16,384: 128
blocks of 128 points, 8 of 16 sums, one of 8).  An aligned subtree of
_tree's perfect binary tree is what its first levels compute there, so the
plan keeps the association.  On CPU tensors they run `fold_plain`, the only
reason they ever do.  `G1_LAUNCHES` / `G2_LAUNCHES` count the kernel
launches of the folds that ran, one a fold, and nothing else.

`fold_plain` computes in radix 2^16 (24 limbs in int64, CIOS Montgomery
with the same R), where the kernel computes in radix 2^32: an int64 has no
room for a 32x32-bit product and its carries.  Canonical Montgomery values
do not depend on the radix, so both give the same limbs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, _check

NL = 48  # 8-bit limbs per Fp element (the rows' layout)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

LEAVES = 128  # points a block of the first tier folds: one aligned subtree
TIER_LEAVES = 16  # block sums a block of a later tier folds

G1_LAUNCHES = 0
G2_LAUNCHES = 0

# (device, stream) -> the kernels' group counters: zeros, and zeros again
# after every fold (its last block of a group wraps the group's counter to 0)
_counters: dict = {}

# ---------------------------------------------------------------------------
# plain version: radix 2^16, 24 limbs in int64
# ---------------------------------------------------------------------------

_L = 24
_MASK = 0xFFFF
_N0 = (-pow(P, -1, 1 << 16)) & _MASK  # -P^-1 mod 2^16
_P16 = np.array([(P >> (16 * k)) & _MASK for k in range(_L)], dtype=np.int64)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Signed limbs -> limbs in [0, 2^16) but the top one, which takes the
    rest (its sign is the value's): carries run until none is left."""
    while True:
        c = x[..., :-1] >> 16
        if not bool(c.any()):
            return x
        x = torch.cat([x[..., :1] & _MASK, (x[..., 1:-1] & _MASK) + c[..., :-1],
                       x[..., -1:] + c[..., -1:]], -1)


def _cond_sub(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x in [0, 2P), normalized -> x mod P."""
    d = _norm(x - p)
    return torch.where((d[..., -1:] >= 0), d, x)


def _fadd(a, b, p):
    return _cond_sub(_norm(a + b), p)


def _fsub(a, b, p):
    return _cond_sub(_norm(a - b + p), p)


def _fmul(a, b, p):
    """Montgomery product a·b·R^-1 mod P (CIOS), canonical."""
    t = torch.zeros(a.shape[:-1] + (_L + 1,), dtype=torch.int64, device=a.device)
    zero = torch.zeros_like(t[..., :1])
    for i in range(_L):
        t[..., :_L] += a[..., i:i + 1] * b
        m = ((t[..., 0:1] & _MASK) * _N0) & _MASK
        t[..., :_L] += m * p
        carry = t[..., 0:1] >> 16  # t[0] is now a multiple of 2^16
        t = torch.cat([t[..., 1:2] + carry, t[..., 2:], zero], -1)
    return _cond_sub(_norm(t)[..., :_L], p)


class _Fp:
    """Fp on [..., 24] tensors."""

    def __init__(self, p):
        self.p = p

    def mul(self, a, b):
        return _fmul(a, b, self.p)

    def add(self, a, b):
        return _fadd(a, b, self.p)

    def sub(self, a, b):
        return _fsub(a, b, self.p)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)

    @staticmethod
    def eq(a, b):
        return (a == b).all(-1)


class _Fp2(_Fp):
    """Fp2 = Fp[u]/(u^2 + 1) on [..., 2, 24] tensors; Karatsuba product."""

    def mul(self, a, b):
        # the three Fp products in one call: a0·b0, a1·b1, (a0 + a1)(b0 + b1)
        lhs = torch.stack([a[..., 0, :], a[..., 1, :], _fadd(a[..., 0, :], a[..., 1, :], self.p)])
        rhs = torch.stack([b[..., 0, :], b[..., 1, :], _fadd(b[..., 0, :], b[..., 1, :], self.p)])
        t = _fmul(lhs, rhs, self.p)
        c0 = _fsub(t[0], t[1], self.p)
        c1 = _fsub(_fsub(t[2], t[0], self.p), t[1], self.p)
        return torch.stack([c0, c1], -2)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1).all(-1)

    @staticmethod
    def eq(a, b):
        return (a == b).all(-1).all(-1)


def _muls(f, a, k: int):
    out = a
    for _ in range(k - 1):
        out = f.add(out, a)
    return out


def _sel(c, a, b):
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - c.dim())), a, b)


def _padd(f, p, q):
    """jax_tier._make_point_add's complete addition on [n, 3, ...] points."""
    x1, y1, z1 = p[:, 0], p[:, 1], p[:, 2]
    x2, y2, z2 = q[:, 0], q[:, 1], q[:, 2]
    mul, add, sub = f.mul, f.add, f.sub
    z1z1 = mul(z1, z1)
    z2z2 = mul(z2, z2)
    u1 = mul(x1, z2z2)
    u2 = mul(x2, z1z1)
    s1 = mul(mul(y1, z2), z2z2)
    s2 = mul(mul(y2, z1), z1z1)
    h = sub(u2, u1)
    i = _muls(f, mul(h, h), 4)
    j = mul(h, i)
    rr = _muls(f, sub(s2, s1), 2)
    v = mul(u1, i)
    x3 = sub(sub(mul(rr, rr), j), _muls(f, v, 2))
    y3 = sub(mul(rr, sub(v, x3)), _muls(f, mul(s1, j), 2))
    z3 = _muls(f, mul(mul(z1, z2), h), 2)
    # the double of p (dbl-2009-l)
    a = mul(x1, x1)
    b = mul(y1, y1)
    c = mul(b, b)
    xb = add(x1, b)
    d = _muls(f, sub(sub(mul(xb, xb), a), c), 2)
    e = _muls(f, a, 3)
    dx = sub(mul(e, e), _muls(f, d, 2))
    dy = sub(mul(e, sub(d, dx)), _muls(f, c, 8))
    dz = _muls(f, mul(y1, z1), 2)
    same_x, same_y = f.eq(u1, u2), f.eq(s1, s2)
    out = _sel(same_x, torch.zeros_like(p), torch.stack([x3, y3, z3], 1))
    out = _sel(same_x & same_y, torch.stack([dx, dy, dz], 1), out)
    out = _sel(f.is_zero(z2), p, out)
    return _sel(f.is_zero(z1), q, out)


def _to16(rows: torch.Tensor) -> torch.Tensor:
    r = rows.to(torch.int64)
    return r[..., 0::2] | (r[..., 1::2] << 8)


def _to8(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x & 0xFF, x >> 8], -1).reshape(x.shape[:-1] + (NL,)).to(torch.int32)


def fold_plain(rows: torch.Tensor) -> torch.Tensor:
    """The fold in plain torch: [bucket, 3, 48] (G1) or [bucket, 3, 2, 48]
    (G2) int32 rows -> [3, 48] or [3, 2, 48] int32, limb for limb the
    kernel's (and jax_tier's) output."""
    _check_bucket(rows.shape[0])
    p = _check.device_const(_P16, rows.device)
    f = _Fp2(p) if rows.dim() == 4 else _Fp(p)
    cur = _to16(rows)
    while cur.shape[0] > 1:  # new[k] = cur[2k] + cur[2k + 1]: _tree's levels
        cur = _padd(f, cur[0::2], cur[1::2])
    return _to8(cur[0])


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check_bucket(bucket: int) -> None:
    if bucket < 2 or bucket & (bucket - 1):
        raise ValueError(f"the fold takes a power-of-two bucket >= 2, got {bucket}")


def plan(bucket: int, leaves: int | None = None, tier_leaves: int | None = None) -> list:
    """The fold's tiers for a bucket: (points a block folds, blocks) of
    each, the first on the rows, every other on the block sums before it,
    the last one block.  A block of the first tier folds an aligned subtree
    of `leaves` (LEAVES) points, a later one `tier_leaves` (TIER_LEAVES)
    block sums, or all that is left where fewer remain."""
    _check_bucket(bucket)
    per = leaves or LEAVES
    later = tier_leaves or TIER_LEAVES
    for k in (per, later):
        if k < 2 or k & (k - 1):
            raise ValueError(f"a block folds a power-of-two count >= 2 of points, got {k}")
    out, n = [], bucket
    while n > 1:
        k = min(per, n)
        out.append((k, n // k))
        n //= k
        per = later
    return out


@functools.lru_cache(maxsize=None)
def _launch_args(bucket: int, leaves: int, tier_leaves: int) -> tuple:
    """A fold's launch arguments that depend on the bucket alone: the block
    sums (one for every block of every tier but the last), the counters (one
    for every block of every tier but the first), each tier's points a block
    (a ctypes array) and the tier count."""
    tiers = plan(bucket, leaves, tier_leaves)
    return (sum(b for _, b in tiers[:-1]), sum(b for _, b in tiers[1:]),
            (ctypes.c_int * len(tiers))(*(k for k, _ in tiers)), len(tiers))


def _launch(name: str, rows: torch.Tensor, coord: tuple, sum_words: int) -> torch.Tensor:
    """Runs the fold's one launch by `plan`; `sum_words`: 32-bit words a
    block sum (G1's carries Z^2 and Z^3 beside X, Y, Z)."""
    bucket = rows.shape[0]
    _check_bucket(bucket)
    _check.tensors(rows.device, rows=(rows, torch.int32, (bucket, 3) + coord))
    sums, n, leaves, tiers = _launch_args(bucket, LEAVES, TIER_LEAVES)
    words = 3 * int(np.prod(coord)) // 4  # 32-bit words a row
    # the output's 8-bit limbs, then the block sums (16-byte aligned)
    buf = torch.empty(4 * words + sums * sum_words, dtype=torch.int32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    counters = _counters.get((rows.device, stream))
    if counters is None or counters.numel() < n:
        counters = _counters[(rows.device, stream)] = torch.zeros(
            max(n, 256), dtype=torch.int32, device=rows.device)
    rc = getattr(_build.lib(), f"{name}_launch")(
        rows.data_ptr(), buf.data_ptr() + 16 * words, counters.data_ptr(), buf.data_ptr(), bucket,
        leaves, tiers, stream,
    )
    _check.launched(name, rc)
    return buf[:4 * words].view((3,) + coord)


def fold_g1(rows: torch.Tensor) -> torch.Tensor:
    """Σ of a bucket of G1 rows [bucket, 3, 48] -> [3, 48] int32."""
    if rows.device.type == "cpu":
        return fold_plain(rows)
    global G1_LAUNCHES
    out = _launch("bls12_381_fold_g1", rows, (NL,), 5 * NL // 4)
    G1_LAUNCHES += 1
    return out


def fold_g2(rows: torch.Tensor) -> torch.Tensor:
    """Σ of a bucket of G2 rows [bucket, 3, 2, 48] -> [3, 2, 48] int32."""
    if rows.device.type == "cpu":
        return fold_plain(rows)
    global G2_LAUNCHES
    out = _launch("bls12_381_fold_g2", rows, (2, NL), 3 * NL // 2)
    G2_LAUNCHES += 1
    return out
