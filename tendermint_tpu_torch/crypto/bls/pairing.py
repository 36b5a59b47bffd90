"""Optimal ate pairing on BLS12-381 with a shared final exponentiation.

`pairing_product(pairs)` computes Π e(Pᵢ, Qᵢ) with one Miller loop per
pair but ONE final exponentiation for the whole product — the "one
pairing-check" primitive every aggregate-commit consumer calls: a k-commit
fastsync run or an N-signer aggregate verify is one call here, not 2k/2N
full pairings.

Miller loop: affine coordinates over the twist; each step's line function
untwists to the sparse Fp12 shape (non-zero coords 0, 1, 4 of the
w-basis), absorbed via `f12_mul_by_014`.  Derivation: with the untwist
(x/w², y/w³) and slope λ' on the twist, the line through R̂ at
P = (xP, yP) ∈ G1, scaled by the final-exp-invisible factor w³, is

    l(P) = (λ'·x'_R - y'_R)  -  λ'·xP · w²  +  yP · w³
         =  c0 + c1·v + c4·vw   (positions 0, 1, 4).

Final exponentiation: easy part f^((p⁶-1)(p²+1)), then the hard part via
the Hayashida–Hayasaka–Teruya decomposition

    3·(p⁴ - p² + 1)/r = (x-1)²·(x+p)·(x²+p²-1) + 3,

an INTEGER identity asserted at import below — so the addition chain
cannot drift from the exponent it claims to compute.  The extra factor 3
means this module computes e(P,Q)³ rather than the canonical ate pairing;
the output still lives in μ_r with r prime and 3 ∤ r, so cubing is a
bijection and every `pairing_check`/bilinearity property is preserved —
only raw-GT test vectors would differ.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from . import curve
from .fields import (
    F12_ONE,
    P,
    R,
    X,
    f2_inv,
    f2_mul,
    f2_muls,
    f2_neg,
    f2_sq,
    f2_sub,
    f12_conj,
    f12_eq,
    f12_frobenius,
    f12_frobenius2,
    f12_inv,
    f12_mul,
    f12_mul_by_014,
    f12_sq,
)

# the HHT hard-part identity, checked as plain integers at import
assert (P**4 - P**2 + 1) % R == 0
assert (X - 1) ** 2 * (X + P) * (X**2 + P**2 - 1) + 3 == 3 * ((P**4 - P**2 + 1) // R)

# |x| bits MSB-first, top bit dropped (the Miller loop seed)
_X_BITS = [int(b) for b in bin(-X)[3:]]


def _line_double(r, xp: int, yp: int):
    """Tangent line at twist point r=(x,y) affine, evaluated at P=(xp,yp).
    Returns (new R, (o0, o1, o4))."""
    x, y = r
    lam = f2_mul(f2_muls(f2_sq(x), 3), f2_inv(f2_muls(y, 2)))
    x3 = f2_sub(f2_sq(lam), f2_muls(x, 2))
    y3 = f2_sub(f2_mul(lam, f2_sub(x, x3)), y)
    o0 = f2_sub(f2_mul(lam, x), y)
    o1 = f2_neg(f2_muls(lam, xp))
    o4 = (yp, 0)
    return (x3, y3), (o0, o1, o4)


def _line_add(r, q, xp: int, yp: int):
    """Chord through twist points r, q, evaluated at P."""
    x1, y1 = r
    x2, y2 = q
    lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    o0 = f2_sub(f2_mul(lam, x1), y1)
    o1 = f2_neg(f2_muls(lam, xp))
    o4 = (yp, 0)
    return (x3, y3), (o0, o1, o4)


def miller_loop(p_aff: Tuple[int, int], q_aff) -> tuple:
    """f_{|x|,Q}(P) ∈ Fp12 (unexponentiated).  Affine inputs; the caller
    conjugates for the negative BLS parameter (done in pairing_product)."""
    xp, yp = p_aff
    f = F12_ONE
    r = q_aff
    for bit in _X_BITS:
        r, line = _line_double(r, xp, yp)
        f = f12_mul_by_014(f12_sq(f), *line)
        if bit:
            r, line = _line_add(r, q_aff, xp, yp)
            f = f12_mul_by_014(f, *line)
    return f


def _pow_x_abs(a):
    """a^|x| by square-and-multiply over the fixed 64-bit parameter."""
    res = a
    for bit in _X_BITS:
        res = f12_sq(res)
        if bit:
            res = f12_mul(res, a)
    return res


def _pow_x(a):
    """a^x for the (negative) BLS parameter; input must lie in the
    cyclotomic subgroup so inversion is conjugation."""
    return f12_conj(_pow_x_abs(a))


def final_exponentiation(f):
    """f^((p¹²-1)/r)."""
    # easy part: f^(p⁶-1) then ^(p²+1)
    t = f12_mul(f12_conj(f), f12_inv(f))
    m = f12_mul(f12_frobenius2(t), t)
    # hard part: m^((x-1)²(x+p)(x²+p²-1)) · m³   (HHT identity above)
    a = f12_mul(_pow_x(m), f12_conj(m))  # m^(x-1)
    a = f12_mul(_pow_x(a), f12_conj(a))  # m^((x-1)²)
    a = f12_mul(_pow_x(a), f12_frobenius(a))  # ^(x+p)
    a = f12_mul(
        f12_mul(_pow_x(_pow_x(a)), f12_frobenius2(a)), f12_conj(a)
    )  # ^(x²+p²-1)
    return f12_mul(a, f12_mul(f12_sq(m), m))  # · m³


def pairing_product(pairs: Sequence[tuple]) -> tuple:
    """Π e(Pᵢ, Qᵢ) for Jacobian (G1 point, G2 point) pairs — one shared
    final exponentiation.  Identity operands contribute the neutral 1.

    Routed through the compiled tier (csrc/bls12_381.c via ctier) when a
    toolchain built it — same HHT decomposition, so the output is
    bit-identical and this pure loop stays the differential reference."""
    ct = _ctier()
    if ct is not None:
        return ct.pairing_product_points(pairs)
    return pairing_product_pure(pairs)


def pairing_product_pure(pairs: Sequence[tuple]) -> tuple:
    """The pure-Python reference product (the differential oracle the C
    tier is pinned against; also the no-toolchain fallback)."""
    f = F12_ONE
    for g1p, g2p in pairs:
        p_aff = curve.g1_affine(g1p)
        q_aff = curve.g2_affine(g2p)
        if p_aff is None or q_aff is None:
            continue
        f = f12_mul(f, miller_loop(p_aff, q_aff))
    f = f12_conj(f)  # negative x: e = f_{|x|}^(-(p¹²-1)/r) ⇒ conjugate first
    return final_exponentiation(f)


def pairing(g1p, g2p) -> tuple:
    return pairing_product([(g1p, g2p)])


def pairing_check(pairs: Sequence[tuple]) -> bool:
    """True iff Π e(Pᵢ, Qᵢ) == 1 — THE verification equation."""
    ct = _ctier()
    if ct is not None:
        return ct.pairing_check_points(pairs)
    return f12_eq(pairing_product_pure(pairs), F12_ONE)


def _ctier():
    """The compiled fast tier, or None (no toolchain / forced pure)."""
    from . import ctier

    return ctier.get()
