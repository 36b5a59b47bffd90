"""Ristretto255 group encoding over the edwards25519 curve arithmetic in
ed25519_math (RFC 9496 ENCODE/DECODE); the port's copy of
tendermint_tpu/crypto/ristretto.py.

Reference parity: the reference's sr25519 keys are ristretto255 points
(go-schnorrkel → ristretto255 crate).  Points here are ed25519_math
extended coordinates; only the byte encoding differs from edwards.
"""

from __future__ import annotations

from typing import Optional

from . import ed25519_math as em

P = em.P
D = em.D
SQRT_M1 = em.SQRT_M1


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """RFC 9496 §4.2 SQRT_RATIO_M1: (was_square, sqrt(u/v) or
    sqrt(i*u/v))."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct_sign = check == u
    flipped_sign = check == (P - u) % P
    flipped_sign_i = check == (P - u) % P * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    return correct_sign or flipped_sign, _abs(r)


# 1/sqrt(a - d) with a = -1 (RFC 9496 §4) = sqrt(1/(a-d))
_ok, INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)
assert _ok, "a - d must be square mod p"


def decode(data: bytes) -> Optional[em.Point]:
    """32 bytes -> extended point, None for invalid encodings."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or _is_negative(s):  # non-canonical or negative
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(p: em.Point) -> bytes:
    """Extended point -> canonical 32-byte encoding (RFC 9496 §4.3.2)."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    ix0 = x0 * SQRT_M1 % P
    iy0 = y0 * SQRT_M1 % P
    enchanted = den1 * INVSQRT_A_MINUS_D % P
    rotate = _is_negative(t0 * z_inv % P)
    if rotate:
        x, y, den_inv = iy0, ix0, enchanted
    else:
        x, y, den_inv = x0, y0, den2
    if _is_negative(x * z_inv % P):
        y = (P - y) % P
    s = _abs(den_inv * ((z0 - y) % P))
    return s.to_bytes(32, "little")


def equals(p: em.Point, q: em.Point) -> bool:
    """Cosets compare via x1*y2 == y1*x2 or y1*y2 == x1*x2 (RFC 9496 §4.5)
    — cheaper than encoding both sides."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return (x1 * y2 - y1 * x2) % P == 0 or (y1 * y2 - x1 * x2) % P == 0


BASEPOINT = em.to_extended(
    15112221349535400772501151409588531511454012693041857206046113283949847762202,
    46316835694926478169428394003475163141307993866256225615783033603165251855960,
)
