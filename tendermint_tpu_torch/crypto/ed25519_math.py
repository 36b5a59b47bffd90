"""Pure-Python ed25519 curve math (host reference path).

Three jobs:
1. Point **decompression** of validator pubkeys when building the
   device-resident table the GPU batch verifier indexes into.
2. A slow-but-obviously-correct host reference for differential tests of
   the torch field layer and CUDA kernels in `ops/`.
3. Cofactorless verification semantics matching the reference's
   golang.org/x/crypto/ed25519 path (crypto/ed25519/ed25519.go:151):
   reject non-canonical S (ScMinimal), compute R' = [s]B + [h](-A) and
   compare the *encoding* of R' with the signature's R bytes — so the new
   framework never forks from the reference on edge-case signatures.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# Extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z.
Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)

# Base point
_By = 4 * pow(5, P - 2, P) % P
_Bx = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASE: Point = (_Bx, _By, 1, (_Bx * _By) % P)


def fe_inv(x: int) -> int:
    return pow(x, P - 2, P)


def sqrt_ratio(u: int, v: int) -> Optional[int]:
    """sqrt(u/v) mod P, or None if non-square. RFC 8032 §5.1.3 method."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    if check == u % P:
        return r
    if check == (-u) % P:
        return r * SQRT_M1 % P
    return None


def decompress(data: bytes) -> Optional[Tuple[int, int]]:
    """Decode 32-byte compressed point to affine (x, y); None if invalid."""
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = sqrt_ratio(u, v)
    if x is None:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y)


def compress(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def to_extended(x: int, y: int) -> Point:
    return (x, y, 1, x * y % P)


def to_affine(p: Point) -> Tuple[int, int]:
    X, Y, Z, _ = p
    zi = fe_inv(Z)
    return (X * zi % P, Y * zi % P)


def point_neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def point_add(p: Point, q: Point) -> Point:
    """Complete twisted-Edwards addition (a=-1): add-2008-hwcd-3.

    Complete for ed25519 (a=-1 square mod P, d non-square), so it is safe
    for P==Q and identity — the property the batched kernels rely
    on for branch-free Straus double-scalar multiplication.
    """
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * 2 * D % P * T2 % P
    Dv = Z1 * 2 * Z2 % P
    E = B - A
    F = Dv - C
    G = Dv + C
    H = B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p: Point) -> Point:
    """dbl-2008-hwcd."""
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + B
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = A - B
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def scalar_mult(k: int, p: Point) -> Point:
    acc = IDENTITY
    addend = p
    while k:
        if k & 1:
            acc = point_add(acc, addend)
        addend = point_double(addend)
        k >>= 1
    return acc


def double_scalar_mult(a: int, A: Point, b: int) -> Point:
    """a*A + b*BASE via Straus (shared doublings), MSB first — the exact
    structure the batched ladder vectorizes."""
    AB = point_add(A, BASE)
    table = (IDENTITY, BASE, A, AB)  # index = 2*a_bit + b_bit
    acc = IDENTITY
    for i in reversed(range(256)):
        acc = point_double(acc)
        sel = 2 * ((a >> i) & 1) + ((b >> i) & 1)
        if sel:
            acc = point_add(acc, table[sel])
    return acc


def sc_reduce(k: int) -> int:
    return k % L


def sc_minimal(s_bytes: bytes) -> bool:
    """Reject non-canonical S — parity with ScMinimal in the reference's
    x/crypto dependency."""
    return int.from_bytes(s_bytes, "little") < L


def compute_hram(r_bytes: bytes, pub_bytes: bytes, msg: bytes) -> int:
    h = hashlib.sha512(r_bytes + pub_bytes + msg).digest()
    return sc_reduce(int.from_bytes(h, "little"))


def verify(pub_bytes: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactorless ed25519 verify, host reference path."""
    if len(sig) != 64 or len(pub_bytes) != 32:
        return False
    if not sc_minimal(sig[32:]):
        return False
    A = decompress(pub_bytes)
    if A is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    h = compute_hram(sig[:32], pub_bytes, msg)
    # R' = [s]B + [h](-A); compare encodings.
    Rp = double_scalar_mult(h, point_neg(to_extended(*A)), s)
    return compress(*to_affine(Rp)) == sig[:32]


def sign(priv_scalar32: bytes, prefix32: bytes, pub_bytes: bytes, msg: bytes) -> bytes:
    """RFC 8032 sign given the expanded key halves (for tests)."""
    a = int.from_bytes(priv_scalar32, "little")
    r = sc_reduce(int.from_bytes(hashlib.sha512(prefix32 + msg).digest(), "little"))
    R = compress(*to_affine(scalar_mult(r, BASE)))
    h = compute_hram(R, pub_bytes, msg)
    s = (r + h * a) % L
    return R + s.to_bytes(32, "little")
