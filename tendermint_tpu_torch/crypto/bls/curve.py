"""BLS12-381 curve groups.

G1: E(Fp):  y² = x³ + 4,        prime-order subgroup of size r.
G2: E'(Fp2): y² = x³ + 4(1+u),  the sextic twist, subgroup of size r.

Points are Jacobian tuples (X, Y, Z) — ints for G1, Fp2 pairs for G2;
Z = 0 (or (0,0)) is the identity.  Serialization follows the ZCash
compressed format (48B G1 / 96B G2, flag bits in the top three bits).

ψ (untwist-Frobenius-twist) and the fast cofactor clearing are DERIVED
from ξ at import — see the inline algebra; tests pin them by checking
cleared points land in the r-subgroup.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .fields import (
    F2_ONE,
    F2_ZERO,
    P,
    R,
    X,
    f2_add,
    f2_conj,
    f2_eq,
    f2_inv,
    f2_is_zero,
    f2_mul,
    f2_muls,
    f2_neg,
    f2_pow,
    f2_sq,
    f2_sqrt,
    f2_sub,
    fp_sqrt,
)

B1 = 4
B2 = (4, 4)  # 4·(1+u)

# group generators (the standard published ones; tests assert on-curve +
# order-r so a transcription slip cannot survive the suite)
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    F2_ONE,
)

G1_INF = (0, 0, 0)
G2_INF = (F2_ZERO, F2_ZERO, F2_ZERO)


# -- G1 (ints) --------------------------------------------------------------


def g1_is_inf(p) -> bool:
    return p[2] == 0


def g1_double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return G1_INF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def g1_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return G1_INF
        return g1_double(p)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    rr = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (rr * rr - j - 2 * v) % P
    y3 = (rr * (v - x3) - 2 * s1 * j) % P
    z3 = 2 * h * z1 * z2 % P
    return (x3, y3, z3)


def g1_neg(p):
    return (p[0], -p[1] % P, p[2])


def g1_mul(p, k: int):
    if k < 0:
        return g1_mul(g1_neg(p), -k)
    acc = G1_INF
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_double(p)
        k >>= 1
    return acc


def g1_affine(p) -> Optional[Tuple[int, int]]:
    """None for the identity."""
    if p[2] == 0:
        return None
    zinv = pow(p[2], P - 2, P)
    z2 = zinv * zinv % P
    return (p[0] * z2 % P, p[1] * z2 * zinv % P)


def g1_eq(p, q) -> bool:
    if p[2] == 0 or q[2] == 0:
        return p[2] == 0 and q[2] == 0
    z1z1 = p[2] * p[2] % P
    z2z2 = q[2] * q[2] % P
    return (
        p[0] * z2z2 % P == q[0] * z1z1 % P
        and p[1] * z2z2 * q[2] % P == q[1] * z1z1 * p[2] % P
    )


def g1_on_curve(p) -> bool:
    if p[2] == 0:
        return True
    aff = g1_affine(p)
    x, y = aff
    return (y * y - x * x * x - B1) % P == 0


def g1_in_subgroup(p) -> bool:
    return g1_on_curve(p) and g1_is_inf(g1_mul(p, R))


# -- G2 (Fp2 coords) --------------------------------------------------------


def g2_is_inf(p) -> bool:
    return f2_is_zero(p[2])


def g2_double(p):
    x, y, z = p
    if f2_is_zero(z) or f2_is_zero(y):
        return G2_INF
    a = f2_sq(x)
    b = f2_sq(y)
    c = f2_sq(b)
    d = f2_muls(f2_sub(f2_sub(f2_sq(f2_add(x, b)), a), c), 2)
    e = f2_muls(a, 3)
    f = f2_sq(e)
    x3 = f2_sub(f, f2_muls(d, 2))
    y3 = f2_sub(f2_mul(e, f2_sub(d, x3)), f2_muls(c, 8))
    z3 = f2_muls(f2_mul(y, z), 2)
    return (x3, y3, z3)


def g2_add(p, q):
    if f2_is_zero(p[2]):
        return q
    if f2_is_zero(q[2]):
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = f2_sq(z1)
    z2z2 = f2_sq(z2)
    u1 = f2_mul(x1, z2z2)
    u2 = f2_mul(x2, z1z1)
    s1 = f2_mul(f2_mul(y1, z2), z2z2)
    s2 = f2_mul(f2_mul(y2, z1), z1z1)
    if f2_eq(u1, u2):
        if not f2_eq(s1, s2):
            return G2_INF
        return g2_double(p)
    h = f2_sub(u2, u1)
    i = f2_muls(f2_sq(h), 4)
    j = f2_mul(h, i)
    rr = f2_muls(f2_sub(s2, s1), 2)
    v = f2_mul(u1, i)
    x3 = f2_sub(f2_sub(f2_sq(rr), j), f2_muls(v, 2))
    y3 = f2_sub(f2_mul(rr, f2_sub(v, x3)), f2_muls(f2_mul(s1, j), 2))
    z3 = f2_muls(f2_mul(f2_mul(z1, z2), h), 2)
    return (x3, y3, z3)


def g2_neg(p):
    return (p[0], f2_neg(p[1]), p[2])


def g2_mul(p, k: int):
    if k < 0:
        return g2_mul(g2_neg(p), -k)
    acc = G2_INF
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_double(p)
        k >>= 1
    return acc


def g2_affine(p):
    if f2_is_zero(p[2]):
        return None
    zinv = f2_inv(p[2])
    z2 = f2_sq(zinv)
    return (f2_mul(p[0], z2), f2_mul(f2_mul(p[1], z2), zinv))


def g2_eq(p, q) -> bool:
    pi, qi = f2_is_zero(p[2]), f2_is_zero(q[2])
    if pi or qi:
        return pi and qi
    z1z1 = f2_sq(p[2])
    z2z2 = f2_sq(q[2])
    return f2_eq(f2_mul(p[0], z2z2), f2_mul(q[0], z1z1)) and f2_eq(
        f2_mul(f2_mul(p[1], z2z2), q[2]), f2_mul(f2_mul(q[1], z1z1), p[2])
    )


def g2_on_curve(p) -> bool:
    if f2_is_zero(p[2]):
        return True
    x, y = g2_affine(p)
    return f2_eq(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), B2))


def g2_in_subgroup(p) -> bool:
    """Fast membership: Q ∈ G2 iff ψ(Q) = [x]Q (Bowe, "Faster subgroup
    checks for BLS12-381"; the check blst ships).  ψ acts on the r-torsion
    as multiplication by x, and the proof rules out the other E'(Fp2)
    subgroups — so one 64-bit scalar mult replaces the 255-bit [r]Q
    ladder.  `g2_in_subgroup_slow` keeps the by-definition check as the
    differential oracle tests pin this against."""
    if not g2_on_curve(p):
        return False
    if g2_is_inf(p):
        return True
    return g2_eq(g2_psi(p), g2_mul(p, X))


def g2_in_subgroup_slow(p) -> bool:
    return g2_on_curve(p) and g2_is_inf(g2_mul(p, R))


# -- ψ endomorphism + fast cofactor clearing --------------------------------
# Untwist-Frobenius-twist: with w⁶ = ξ the untwist is (x/w², y/w³), so
#   ψ(x, y) = (cₓ·x̄, c_y·ȳ) with cₓ = ξ^-((p-1)/3), c_y = ξ^-((p-1)/2)
# (x̄ = Frobenius = Fp2 conjugation).  Both constants are computed here,
# never transcribed.

_PSI_CX = f2_inv(f2_pow((1, 1), (P - 1) // 3))
_PSI_CY = f2_inv(f2_pow((1, 1), (P - 1) // 2))


def g2_psi(p):
    x, y = g2_affine(p) if not f2_is_zero(p[2]) else (None, None)
    if x is None:
        return G2_INF
    return (f2_mul(_PSI_CX, f2_conj(x)), f2_mul(_PSI_CY, f2_conj(y)), F2_ONE)


def g2_clear_cofactor(p):
    """Budroni–Pintore: [x²-x-1]P + [x-1]ψ(P) + ψ²([2]P) lands any
    E'(Fp2) point in the r-subgroup without the ~510-bit plain-cofactor
    scalar mult (ψ²ψ-free derivation above; subgroup membership of the
    output is pinned by tests)."""
    t1 = g2_mul(p, X)  # [x]P   (X negative: handled by g2_mul)
    t2 = g2_sub(t1, p)  # [x-1]P
    t3 = g2_mul(t2, X)  # [x²-x]P
    out = g2_sub(t3, p)  # [x²-x-1]P
    out = g2_add(out, g2_psi(t2))  # + [x-1]ψ(P)
    out = g2_add(out, g2_psi(g2_psi(g2_double(p))))  # + ψ²([2]P)
    return out


def g2_sub(p, q):
    return g2_add(p, g2_neg(q))


# -- serialization (ZCash flags: bit7 compressed, bit6 infinity, bit5 sign) -


def _fp_larger(y: int) -> bool:
    return y > (P - 1) // 2


def _fp2_larger(y) -> bool:
    """Lexicographic y > -y, c1 first (the ZCash G2 sign rule)."""
    c0, c1 = y[0] % P, y[1] % P
    if c1 != 0:
        return c1 > (P - 1) // 2
    return c0 > (P - 1) // 2


def g1_compress(p) -> bytes:
    aff = g1_affine(p)
    if aff is None:
        return bytes([0xC0]) + b"\x00" * 47
    x, y = aff
    flags = 0x80 | (0x20 if _fp_larger(y) else 0)
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g1_decompress(data: bytes):
    """-> Jacobian point or None.  Checks curve AND subgroup."""
    if len(data) != 48 or not data[0] & 0x80:
        return None
    flags, rest = data[0], bytearray(data)
    rest[0] &= 0x1F
    x = int.from_bytes(bytes(rest), "big")
    if flags & 0x40:
        if x != 0 or flags & 0x20 or any(data[1:]):
            return None
        return G1_INF
    if x >= P:
        return None
    y = fp_sqrt((x * x * x + B1) % P)
    if y is None:
        return None
    if _fp_larger(y) != bool(flags & 0x20):
        y = P - y
    pt = (x, y, 1)
    if not g1_in_subgroup(pt):
        return None
    return pt


def g2_compress(p) -> bytes:
    aff = g2_affine(p)
    if aff is None:
        return bytes([0xC0]) + b"\x00" * 95
    (x0, x1), y = aff
    flags = 0x80 | (0x20 if _fp2_larger(y) else 0)
    b = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g2_decompress(data: bytes):
    if len(data) != 96 or not data[0] & 0x80:
        return None
    flags, rest = data[0], bytearray(data)
    rest[0] &= 0x1F
    x1 = int.from_bytes(bytes(rest[:48]), "big")
    x0 = int.from_bytes(bytes(rest[48:]), "big")
    if flags & 0x40:
        if x0 or x1 or flags & 0x20 or any(data[1:]):
            return None
        return G2_INF
    if x0 >= P or x1 >= P:
        return None
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sq(x), x), B2))
    if y is None:
        return None
    if _fp2_larger(y) != bool(flags & 0x20):
        y = f2_neg(y)
    pt = (x, y, F2_ONE)
    if not g2_in_subgroup(pt):
        return None
    return pt
