"""Twisted-Edwards point arithmetic on the plain torch field layer.

The port's counterpart of tendermint_tpu/ops/curve.py: complete point add
(add-2008-hwcd-3, a=-1), mixed add with a madd-form affine point
(madd-2008-hwcd-3), doubling (dbl-2008-hwcd), branch-free table selection,
the d·(−A) table chain, the ref10 inversion chain and strict
canonicalization.  The JAX module takes a field namespace `fo` because it
serves two backends; here there is one field layer (ops/fe.py), so the
functions call it directly.  The CUDA kernels evaluate the same formulas in
the same order, so their projective coordinates agree with these mod p.

A field element is a [N_LIMBS, B] int32 tensor; a point is a 4-tuple
(X, Y, Z, T) of field elements.
"""

from __future__ import annotations

import torch

from . import fe


def point_add(p, q, two_d):
    """Complete addition, add-2008-hwcd-3 (a=-1) — safe for P==Q and
    identity, which is what makes the ladder branch-free."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = fe.mul(fe.sub(y1, x1), fe.sub(y2, x2))
    b = fe.mul(fe.add(y1, x1), fe.add(y2, x2))
    c = fe.mul(fe.mul(t1, two_d), t2)
    zz = fe.mul(z1, z2)
    d = fe.add(zz, zz)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_madd(p, q3):
    """Mixed addition with a precomputed affine point in madd form
    q3 = (y2−x2, y2+x2, 2d·x2·y2), Z2=1 — 7 muls (madd-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    ymx2, ypx2, td2 = q3
    a = fe.mul(fe.sub(y1, x1), ymx2)
    b = fe.mul(fe.add(y1, x1), ypx2)
    c = fe.mul(t1, td2)
    d = fe.add(z1, z1)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_double(p):
    """dbl-2008-hwcd: 4 muls + 4 squares."""
    x1, y1, z1, _ = p
    a = fe.square(x1)
    b = fe.square(y1)
    zz = fe.square(z1)
    c = fe.add(zz, zz)
    h = fe.add(a, b)
    e = fe.sub(h, fe.square(fe.add(x1, y1)))
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_where(m, p1, p0):
    """Branch-free per-lane select between two points; m: [B] bool."""
    mm = m[None, :]
    return tuple(torch.where(mm, c1, c0) for c1, c0 in zip(p1, p0))


def select_point(entries, digit):
    """entries: list of 16 points; digit: [B] int in [0,16).  4-level
    where-tree, complete in 15 selects (same tree as the JAX package)."""
    cur = list(entries)
    for k in range(4):
        bit = ((digit >> k) & 1).bool()
        cur = [point_where(bit, cur[2 * i + 1], cur[2 * i]) for i in range(len(cur) // 2)]
    return cur[0]


def select_triplet(entries, digit):
    """Same where-tree over 16 3-tuples (madd-form base-table entries)."""
    cur = list(entries)
    for k in range(4):
        bit = ((digit >> k) & 1).bool()[None, :]
        cur = [
            tuple(torch.where(bit, c1, c0) for c1, c0 in zip(cur[2 * i + 1], cur[2 * i]))
            for i in range(len(cur) // 2)
        ]
    return cur[0]


def neg_a_table(a1, identity, two_d):
    """d·(−A) for d=0..15: 7 doubles + 7 adds, shared-subexpression chain."""
    tab = [identity] * 16
    tab[1] = a1
    for d in range(2, 16):
        tab[d] = point_double(tab[d // 2]) if d % 2 == 0 else point_add(tab[d - 1], a1, two_d)
    return tab


def invert(z):
    """z^(p-2) via the ref10 addition chain (254 squarings + 11 multiplies)."""

    def sq_n(x, n):
        for _ in range(n):
            x = fe.square(x)
        return x

    z2 = fe.square(z)  # 2
    z8 = sq_n(z2, 2)  # 8
    z9 = fe.mul(z8, z)  # 9
    z11 = fe.mul(z9, z2)  # 11
    z22 = fe.square(z11)  # 22
    z_5_0 = fe.mul(z22, z9)  # 2^5 - 2^0
    z_10_0 = fe.mul(sq_n(z_5_0, 5), z_5_0)  # 2^10 - 2^0
    z_20_0 = fe.mul(sq_n(z_10_0, 10), z_10_0)  # 2^20 - 2^0
    z_40_0 = fe.mul(sq_n(z_20_0, 20), z_20_0)  # 2^40 - 2^0
    z_50_0 = fe.mul(sq_n(z_40_0, 10), z_10_0)  # 2^50 - 2^0
    z_100_0 = fe.mul(sq_n(z_50_0, 50), z_50_0)  # 2^100 - 2^0
    z_200_0 = fe.mul(sq_n(z_100_0, 100), z_100_0)  # 2^200 - 2^0
    z_250_0 = fe.mul(sq_n(z_200_0, 50), z_50_0)  # 2^250 - 2^0
    return fe.mul(sq_n(z_250_0, 5), z11)  # 2^255 - 21 = p - 2


def canonical(x):
    """Full reduction to [0, p) with strictly normalized limbs — required
    before the limb-compare against a signature's raw R limbs (a partially
    reduced representative would wrongly fail limb-wise equality)."""
    n = fe.N_LIMBS
    bits = fe.LIMB_BITS
    mask = fe.MASK

    def seq_carry(rows):
        out = []
        carry = torch.zeros_like(rows[0])
        for i in range(n):
            v = rows[i] + carry
            carry = v >> bits
            out.append(v & mask)
        return out, carry

    rows = [x[i : i + 1] for i in range(n)]
    rows, carry = seq_carry(rows)  # value < 1.3*2^260 -> carry <= 1
    rows[0] = rows[0] + fe.FOLD * carry
    rows, _ = seq_carry(rows)  # value now < 2^260 -> no top carry
    # fold bits >= 255 (top 5 bits of limb 19): 2^255 ≡ 19
    top = rows[n - 1] >> 8
    rows[n - 1] = rows[n - 1] & 0xFF
    rows[0] = rows[0] + 19 * top
    rows, _ = seq_carry(rows)  # value < 2^255 + 589 < 2p
    p_limbs = [int(fe.P_LIMBS[i, 0]) for i in range(n)]
    for _ in range(2):
        borrow = torch.zeros_like(rows[0])
        t = []
        for i in range(n):
            v = rows[i] - p_limbs[i] - borrow
            borrow = (v < 0).to(torch.int32)
            t.append(v + borrow * (mask + 1))
        keep = borrow == 0
        rows = [torch.where(keep, ti, ri) for ti, ri in zip(t, rows)]
    return torch.cat(rows, dim=0)
