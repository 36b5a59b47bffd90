"""hash_to_curve for G2: RFC 9380 machinery (expand_message_xmd/SHA-256,
hash_to_field, map_to_curve, clear_cofactor), random-oracle construction.

map_to_curve is the Shallue–van de Woestijne map (RFC 9380 §6.6.1) rather
than the SSWU+3-isogeny of the `..._SSWU_RO_` suites: SvdW's constants
(Z, c1..c4) are fully DERIVED from the curve equation by the RFC's own
find_z_svdw procedure, implemented below — whereas the G2 SSWU route
needs the published 3-isogeny coefficient tables, which cannot be
safely (re)derived offline.  Same security reduction, same wire shapes;
swapping the map for SSWU once the tables are importable is a one-function
change plus a DST bump.  The suite is therefore named
`BLS12381G2_XMD:SHA-256_SVDW_RO` in every DST (scheme.py).

Determinism across nodes is what consensus needs; tests pin outputs and
prove on-curve + in-subgroup over random messages.
"""

from __future__ import annotations

import hashlib
import struct

from . import curve
from .fields import (
    P,
    f2_add,
    f2_eq,
    f2_inv,
    f2_is_square,
    f2_is_zero,
    f2_mul,
    f2_muls,
    f2_neg,
    f2_sgn0,
    f2_sq,
    f2_sqrt,
    f2_sub,
)

# hash_to_field parameters for Fp2 / SHA-256 (RFC 9380 §5, §8.8):
# L = ceil((381 + 128)/8) = 64, m = 2, count = 2 for the RO construction.
_L = 64
_H_OUT = 32
_H_BLOCK = 64


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256."""
    if len(dst) > 255:
        dst = b"H2C-OVERSIZE-DST-" + hashlib.sha256(dst).digest()
    ell = (len_in_bytes + _H_OUT - 1) // _H_OUT
    if ell > 255:
        raise ValueError("len_in_bytes too large for xmd")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _H_BLOCK
    l_i_b = struct.pack(">H", len_in_bytes)
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = b
    for i in range(2, ell + 1):
        b = hashlib.sha256(
            bytes(x ^ y for x, y in zip(b0, b)) + bytes([i]) + dst_prime
        ).digest()
        out += b
    return out[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, dst: bytes, count: int):
    """RFC 9380 §5.2: `count` elements of Fp2."""
    uniform = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = _L * (j + i * 2)
            coords.append(int.from_bytes(uniform[off : off + _L], "big") % P)
        out.append((coords[0], coords[1]))
    return out


# -- Shallue–van de Woestijne constants, derived per RFC 9380 §H.1 ----------


def _g(x):
    """g(x) = x³ + B on the twist (A = 0)."""
    return f2_add(f2_mul(f2_sq(x), x), curve.B2)


def _find_z_svdw():
    """find_z_svdw(F, A, B): first Z in the RFC's non-negative/negative
    spiral over small Fp2 elements meeting the four criteria."""

    def candidates():
        k = 1
        while True:
            for c0, c1 in ((k, 0), (0, k), (k, k)):
                yield (c0, c1)
                yield (-c0 % P, -c1 % P)
            k += 1

    for z in candidates():
        gz = _g(z)
        if f2_is_zero(gz):
            continue
        h = f2_muls(f2_sq(z), 3)  # 3Z² + 4A, A = 0
        if f2_is_zero(h):
            continue
        ratio = f2_neg(f2_mul(h, f2_inv(f2_muls(gz, 4))))  # -(3Z²+4A)/(4g(Z))
        if f2_is_zero(ratio) or not f2_is_square(ratio):
            continue
        if f2_is_square(gz) or f2_is_square(_g(f2_neg(f2_muls(z, (P + 1) // 2)))):
            return z
    raise AssertionError("unreachable: no SvdW Z found")


Z = _find_z_svdw()
_GZ = _g(Z)
_C1 = _GZ
_C2 = f2_neg(f2_muls(Z, (P + 1) // 2))  # -Z/2
_H3 = f2_muls(f2_sq(Z), 3)  # 3Z²
_C3 = f2_sqrt(f2_neg(f2_mul(_GZ, _H3)))
assert _C3 is not None, "sqrt(-g(Z)·3Z²) must exist by choice of Z"
if f2_sgn0(_C3) == 1:  # RFC: fix the sign of c3
    _C3 = f2_neg(_C3)
_C4 = f2_neg(f2_mul(f2_muls(_GZ, 4), f2_inv(_H3)))  # -4g(Z)/(3Z²)


def map_to_curve_svdw(u):
    """RFC 9380 §6.6.1 straight-line SvdW; returns an E'(Fp2) point (NOT
    yet in the r-subgroup)."""
    tv1 = f2_mul(f2_sq(u), _C1)
    tv2 = f2_add((1, 0), tv1)
    tv1 = f2_sub((1, 0), tv1)
    tv3 = f2_mul(tv1, tv2)
    tv3 = f2_inv(tv3) if not f2_is_zero(tv3) else (0, 0)  # inv0
    tv4 = f2_mul(f2_mul(f2_mul(u, tv1), tv3), _C3)
    x1 = f2_sub(_C2, tv4)
    gx1 = _g(x1)
    e1 = f2_is_square(gx1)
    x2 = f2_add(_C2, tv4)
    gx2 = _g(x2)
    e2 = f2_is_square(gx2) and not e1
    x3 = f2_add(f2_mul(f2_sq(f2_mul(f2_sq(tv2), tv3)), _C4), Z)
    x = x3
    if e1:
        x = x1
    elif e2:
        x = x2
    gx = _g(x)
    y = f2_sqrt(gx)
    assert y is not None, "SvdW selected a non-square g(x)"
    if f2_sgn0(u) != f2_sgn0(y):
        y = f2_neg(y)
    return (x, y, (1, 0))


def hash_to_g2(msg: bytes, dst: bytes):
    """Random-oracle hash to the G2 subgroup (Jacobian point)."""
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    q0 = map_to_curve_svdw(u0)
    q1 = map_to_curve_svdw(u1)
    return curve.g2_clear_cofactor(curve.g2_add(q0, q1))
