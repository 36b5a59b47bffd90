"""Batched cofactorless ed25519 verification — the plain torch windowed
Straus ladder.

The reference (plain) version of kernel 1 (csrc/ed25519_ladder.cu, wrapper
ops/ed25519_cuda.py), and the port's counterpart of
tendermint_tpu/ops/ed25519.py.  Per signature it computes
R' = [s]B + [h](−A) with a 4-bit windowed Straus ladder (64 iterations of 4
shared doublings + one add from the per-signature d·(−A) table + one madd
from the fixed-base table) and compares R's canonical encoding limb for
limb against the signature's raw R limbs — so a non-canonical R (y >= p)
fails exactly as the host path does.

Host prep (crypto/batch_verifier.py) supplies decompressed −A rows, the
4-bit digits of h = SHA-512(R‖A‖M) mod L and of s, and R's raw limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import ed25519_math as em
from . import curve, fe

N_WINDOWS = 64  # 4-bit windows covering full 256-bit scalars

TWO_D = fe.from_int(2 * em.D % em.P)

# identity in extended coordinates (0, 1, 1, 0) as [20, 1] constants
IDENTITY = (fe.from_int(0), fe.from_int(1), fe.from_int(1), fe.from_int(0))


def _build_base_table() -> np.ndarray:
    """[16, 3, 20] int32: d·B for d=0..15 in madd form (y−x, y+x, 2d·x·y).
    Entry 0 is the identity's madd form (1, 1, 0)."""
    rows = np.zeros((16, 3, fe.N_LIMBS), dtype=np.int32)
    rows[0, 0] = fe.from_int(1)[:, 0]
    rows[0, 1] = fe.from_int(1)[:, 0]
    pt = em.IDENTITY
    for d in range(1, 16):
        pt = em.point_add(pt, em.BASE)
        x, y = em.to_affine(pt)
        rows[d, 0] = fe.from_int((y - x) % em.P)[:, 0]
        rows[d, 1] = fe.from_int((y + x) % em.P)[:, 0]
        rows[d, 2] = fe.from_int(2 * em.D * x % em.P * y % em.P)[:, 0]
    return rows


BASE_TABLE = _build_base_table()


def identity(batch: int, device):
    return tuple(fe.broadcast_const(c, batch, device).clone() for c in IDENTITY)


def encode_point(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Canonical affine limbs x, y [20, B] -> [B, 32] uint8 encodings
    (y little-endian with x's parity in bit 255)."""
    y64 = y.to(torch.int64)
    cols = []
    for k in range(32):
        i, sh = divmod(8 * k, fe.LIMB_BITS)
        v = y64[i] >> sh
        if i + 1 < fe.N_LIMBS and sh + 8 > fe.LIMB_BITS:
            v = v | (y64[i + 1] << (fe.LIMB_BITS - sh))
        cols.append(v & 0xFF)
    out = torch.stack(cols, dim=1)
    out[:, 31] |= (x[0].to(torch.int64) & 1) << 7
    return out.to(torch.uint8)


def finish(acc, r_y_raw, r_sign, want_r: bool = False):
    """Projective R' -> (ok [B] bool[, R' bytes [B, 32]]): invert Z,
    canonicalize, and compare against the raw R limbs and sign bit."""
    zinv = curve.invert(acc[2])
    x = curve.canonical(fe.mul(acc[0], zinv))
    y = curve.canonical(fe.mul(acc[1], zinv))
    ok_y = fe.eq(y, r_y_raw.to(torch.int32).T)
    ok_sign = (x[0] & 1) == r_sign.to(torch.int32)
    ok = ok_y & ok_sign
    if want_r:
        return ok, encode_point(x, y)
    return ok


def verify_prepared(
    neg_a: torch.Tensor,  # [B, 4, 20] int extended coords of -A
    h_digits: torch.Tensor,  # [B, 64] 4-bit digits of h, MSB first
    s_digits: torch.Tensor,  # [B, 64] 4-bit digits of s, MSB first
    r_y_raw: torch.Tensor,  # [B, 20] raw (unreduced) y limbs from sig R bytes
    r_sign: torch.Tensor,  # [B] x-parity bit from sig R bytes
    want_r: bool = False,
):
    """[B] bool: does [s]B + [h](−A) encode to the signature's R.  With
    `want_r`, also the [B, 32] encoding of the computed R'."""
    batch = neg_a.shape[0]
    dev = neg_a.device
    na = neg_a.to(torch.int32).permute(1, 2, 0)  # [4, 20, B]
    a1 = (na[0], na[1], na[2], na[3])
    two_d = fe.const(TWO_D, dev)
    a_tab = curve.neg_a_table(a1, identity(batch, dev), two_d)
    hd = h_digits.to(torch.int32).T  # [64, B]: window digits, MSB first
    sd = s_digits.to(torch.int32).T
    base_tab = fe.const(BASE_TABLE, dev)
    acc = identity(batch, dev)
    for i in range(N_WINDOWS):
        for _ in range(4):
            acc = curve.point_double(acc)
        acc = curve.point_add(acc, curve.select_point(a_tab, hd[i]), two_d)
        q = base_tab[sd[i].long()].permute(1, 2, 0)  # [3, 20, B]
        acc = curve.point_madd(acc, (q[0], q[1], q[2]))
    return finish(acc, r_y_raw, r_sign, want_r)


def expand_digits(packed_le: torch.Tensor) -> torch.Tensor:
    """[B, 32] little-endian scalar bytes -> [B, 64] 4-bit window digits,
    MSB first (the kernel expands the same bytes in its prologue)."""
    lo = packed_le & 15
    hi = packed_le >> 4
    dig = torch.stack([lo, hi], dim=-1).reshape(packed_le.shape[0], 64)
    return dig.flip(1)


def verify_prepared_packed(neg_a, h_le, s_le, r_y_raw, r_sign, want_r: bool = False):
    """verify_prepared on packed 32-byte LE scalars (the kernel's input
    format).  Bit-identical to expanding on the host: digits are 4-bit."""
    return verify_prepared(
        neg_a, expand_digits(h_le), expand_digits(s_le), r_y_raw, r_sign, want_r
    )
