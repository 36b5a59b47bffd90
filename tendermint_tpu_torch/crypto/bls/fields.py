"""BLS12-381 extension-field tower: Fp2 = Fp[u]/(u²+1), Fp6 = Fp2[v]/(v³-ξ),
Fp12 = Fp6[w]/(w²-v), with ξ = 1+u.

Representation is deliberately flat — tuples of python ints and
module-level functions, no element classes — because the pairing below
runs thousands of Fp multiplies per call and attribute dispatch would
dominate.  Python's native bignum gives exact 381-bit arithmetic; `% P`
after every product keeps magnitudes at one word-burst.

All derived constants (Frobenius coefficients, sqrt exponents) are
computed at import from P and ξ — nothing is transcribed from tables, so
a typo'd magic constant cannot silently corrupt consensus crypto.
"""

from __future__ import annotations

from typing import Tuple

# base field prime and subgroup order (the two published constants this
# module takes on faith; both are pinned by generator/self-checks in tests)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter: p and r are polynomials in x (r = x⁴ - x² + 1)
X = -0xD201000000010000

assert (X**4 - X**2 + 1) == R, "BLS parameter x inconsistent with r"
assert ((X - 1) ** 2 * R) % 3 == 0 and ((X - 1) ** 2 // 3) * R + X == P, (
    "BLS parameter x inconsistent with p"
)

Fp2 = Tuple[int, int]

F2_ZERO: Fp2 = (0, 0)
F2_ONE: Fp2 = (1, 0)
XI: Fp2 = (1, 1)  # the Fp6 non-residue ξ = 1 + u


# -- Fp2 --------------------------------------------------------------------


def f2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: Fp2) -> Fp2:
    return (-a[0] % P, -a[1] % P)


def f2_conj(a: Fp2) -> Fp2:
    """a₀ - a₁u — also the p-power Frobenius on Fp2 (u^p = -u)."""
    return (a[0], -a[1] % P)


def f2_mul(a: Fp2, b: Fp2) -> Fp2:
    # (a0+a1u)(b0+b1u) with u² = -1; Karatsuba saves one base mul
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sq(a: Fp2) -> Fp2:
    # (a0+a1u)² = (a0+a1)(a0-a1) + 2a0a1·u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def f2_muls(a: Fp2, s: int) -> Fp2:
    """Multiply by an Fp scalar."""
    return (a[0] * s % P, a[1] * s % P)


def f2_mul_xi(a: Fp2) -> Fp2:
    """Multiply by ξ = 1+u: (a0 - a1) + (a0 + a1)u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def f2_inv(a: Fp2) -> Fp2:
    """1/(a0+a1u) = (a0 - a1u)/(a0² + a1²)."""
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    inv = pow(norm, P - 2, P)
    return (a[0] * inv % P, -a[1] * inv % P)


def f2_eq(a: Fp2, b: Fp2) -> bool:
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


def f2_is_zero(a: Fp2) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def f2_pow(a: Fp2, e: int) -> Fp2:
    res = F2_ONE
    base = a
    while e:
        if e & 1:
            res = f2_mul(res, base)
        base = f2_sq(base)
        e >>= 1
    return res


def f2_is_square(a: Fp2) -> bool:
    """Euler criterion via the norm map: a is a square in Fp2 iff
    N(a) = a^(p+1) = a0²+a1² is a square in Fp (or a == 0)."""
    if f2_is_zero(a):
        return True
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    return pow(norm, (P - 1) // 2, P) == 1


def fp_sqrt(a: int):
    """Square root in Fp (p ≡ 3 mod 4): a^((p+1)/4), or None."""
    a %= P
    if a == 0:
        return 0
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a else None


def f2_sqrt(a: Fp2):
    """Square root via the complex method (u² = -1 makes Fp2 literally
    Fp(i)): δ = sqrt(a0²+a1²) ∈ Fp, then a = (x + yu)² with
    x² = (a0 ± δ)/2, y = a1/(2x).  Returns None for non-residues."""
    a = (a[0] % P, a[1] % P)
    if a[1] == 0:
        s = fp_sqrt(a[0])
        if s is not None:
            return (s, 0)
        s = fp_sqrt(-a[0] % P)  # a0 = -(s²) → sqrt = s·u
        if s is not None:
            return (0, s)
        return None
    delta = fp_sqrt((a[0] * a[0] + a[1] * a[1]) % P)
    if delta is None:
        return None
    inv2 = (P + 1) // 2  # 1/2 mod p
    for d in (delta, -delta % P):
        t = (a[0] + d) * inv2 % P
        x = fp_sqrt(t)
        if x is None or x == 0:
            continue
        y = a[1] * pow(2 * x % P, P - 2, P) % P
        cand = (x, y)
        if f2_eq(f2_sq(cand), a):
            return cand
    return None


def f2_sgn0(a: Fp2) -> int:
    """RFC 9380 §4.1 sgn0 for m=2: parity of the first non-zero coord."""
    if a[0] % P != 0:
        return (a[0] % P) & 1
    return (a[1] % P) & 1


# -- Fp6 = Fp2[v]/(v³ - ξ) --------------------------------------------------
# element: (c0, c1, c2) with value c0 + c1·v + c2·v²

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    # Toom/Karatsuba-lite: 6 Fp2 muls + ξ folds (v³ = ξ)
    t0 = f2_mul(a[0], b[0])
    t1 = f2_mul(a[1], b[1])
    t2 = f2_mul(a[2], b[2])
    c0 = f2_add(
        t0,
        f2_mul_xi(
            f2_sub(f2_mul(f2_add(a[1], a[2]), f2_add(b[1], b[2])), f2_add(t1, t2))
        ),
    )
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a[0], a[1]), f2_add(b[0], b[1])), f2_add(t0, t1)),
        f2_mul_xi(t2),
    )
    c2 = f2_add(
        f2_sub(f2_mul(f2_add(a[0], a[2]), f2_add(b[0], b[2])), f2_add(t0, t2)), t1
    )
    return (c0, c1, c2)


def f6_sq(a):
    return f6_mul(a, a)


def f6_mul_f2(a, s: Fp2):
    return (f2_mul(a[0], s), f2_mul(a[1], s), f2_mul(a[2], s))


def f6_mul_v(a):
    """Multiply by v: (c0,c1,c2) -> (ξ·c2, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    """Itoh-style 3-term inversion via the adjoint matrix."""
    c0 = f2_sub(f2_sq(a[0]), f2_mul_xi(f2_mul(a[1], a[2])))
    c1 = f2_sub(f2_mul_xi(f2_sq(a[2])), f2_mul(a[0], a[1]))
    c2 = f2_sub(f2_sq(a[1]), f2_mul(a[0], a[2]))
    norm = f2_add(
        f2_mul(a[0], c0), f2_mul_xi(f2_add(f2_mul(a[2], c1), f2_mul(a[1], c2)))
    )
    ninv = f2_inv(norm)
    return (f2_mul(c0, ninv), f2_mul(c1, ninv), f2_mul(c2, ninv))


def f6_eq(a, b):
    return f2_eq(a[0], b[0]) and f2_eq(a[1], b[1]) and f2_eq(a[2], b[2])


# -- Fp12 = Fp6[w]/(w² - v) -------------------------------------------------
# element: (c0, c1) with value c0 + c1·w

F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(
        f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), f6_add(t0, t1)
    )
    return (c0, c1)


def f12_sq(a):
    # complex squaring: (c0+c1w)² = (c0²+v·c1²) + 2c0c1·w
    t = f6_mul(a[0], a[1])
    c0 = f6_sub(
        f6_mul(f6_add(a[0], a[1]), f6_add(a[0], f6_mul_v(a[1]))),
        f6_add(t, f6_mul_v(t)),
    )
    c1 = f6_add(t, t)
    return (c0, c1)


def f12_inv(a):
    norm = f6_sub(f6_sq(a[0]), f6_mul_v(f6_sq(a[1])))
    ninv = f6_inv(norm)
    return (f6_mul(a[0], ninv), f6_neg(f6_mul(a[1], ninv)))


def f12_conj(a):
    """a^(p⁶): w^(p⁶) = -w, so conjugation negates the odd part.  In the
    cyclotomic subgroup (after the easy final-exp part) this is also the
    inverse — the cheap negative-exponent trick the hard part leans on."""
    return (a[0], f6_neg(a[1]))


def f12_eq(a, b):
    return f6_eq(a[0], b[0]) and f6_eq(a[1], b[1])


def f12_pow(a, e: int):
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    res = F12_ONE
    base = a
    while e:
        if e & 1:
            res = f12_mul(res, base)
        base = f12_sq(base)
        e >>= 1
    return res


def f12_mul_by_014(f, o0: Fp2, o1: Fp2, o4: Fp2):
    """Sparse multiply by an element with non-zero Fp2 coords only at
    positions (0, 1, 4) of the 6-vector [a0,a1,a2,b0,b1,b2] — the shape of
    every Miller-loop line evaluation (pairing.py).  ~40% of a full mul."""
    a, b = f
    # x = (o0, o1, 0) (the Fp6 'a' part), y = (0, o4, 0) (the 'b' part)
    t0 = (
        f2_mul(a[0], o0),
        f2_add(f2_mul(a[1], o0), f2_mul(a[0], o1)),
        f2_add(f2_mul(a[2], o0), f2_mul(a[1], o1)),
    )
    t0 = (f2_add(t0[0], f2_mul_xi(f2_mul(a[2], o1))), t0[1], t0[2])
    t1 = (
        f2_mul_xi(f2_mul(b[2], o4)),
        f2_mul(b[0], o4),
        f2_mul(b[1], o4),
    )
    c0 = f6_add(t0, f6_mul_v(t1))
    # (a+b)(x+y) - ax - by  with x+y = (o0, o1+o4, 0)
    o14 = f2_add(o1, o4)
    ab = f6_add(a, b)
    t2 = (
        f2_add(f2_mul(ab[0], o0), f2_mul_xi(f2_mul(ab[2], o14))),
        f2_add(f2_mul(ab[1], o0), f2_mul(ab[0], o14)),
        f2_add(f2_mul(ab[2], o0), f2_mul(ab[1], o14)),
    )
    c1 = f6_sub(t2, f6_add(t0, t1))
    return (c0, c1)


# -- Frobenius --------------------------------------------------------------
# γ1[j] = ξ^(j·(p-1)/6): coefficients of the p-power map in the w-basis.
# Derived, not transcribed: ξ^((p-1)/6) ∈ Fp2 because 6 | p-1... computed
# directly with f2_pow at import (cheap, once).

_G1C = [f2_pow(XI, j * (P - 1) // 6) for j in range(6)]
# p²-power coefficients are norms of the above → live in Fp
_G2C = [f2_mul(_G1C[j], f2_conj(_G1C[j])) for j in range(6)]


def f12_frobenius(a):
    """a^p.  Conjugate every Fp2 coefficient, then scale coordinate j of
    the w-basis by γ1[j]."""
    (a0, a1, a2), (b0, b1, b2) = a
    return (
        (
            f2_conj(a0),
            f2_mul(f2_conj(a1), _G1C[2]),
            f2_mul(f2_conj(a2), _G1C[4]),
        ),
        (
            f2_mul(f2_conj(b0), _G1C[1]),
            f2_mul(f2_conj(b1), _G1C[3]),
            f2_mul(f2_conj(b2), _G1C[5]),
        ),
    )


def f12_frobenius2(a):
    """a^(p²) — coefficients are in Fp, no conjugation."""
    (a0, a1, a2), (b0, b1, b2) = a
    return (
        (a0, f2_mul(a1, _G2C[2]), f2_mul(a2, _G2C[4])),
        (
            f2_mul(b0, _G2C[1]),
            f2_mul(b1, _G2C[3]),
            f2_mul(b2, _G2C[5]),
        ),
    )
