"""Tabulated ed25519 verification: zero-doubling sums over per-validator
window tables.

    table[v, w, d] = d · 16^w · (−A_v)   (w = 0..63, d = 0..15)

Signature i against validator idx_i then needs no doublings:

    [h](−A) + [s]B = Σ_w table[idx_i, w, h_w] + Σ_w base[w, s_w]

128 point adds instead of the ladder's 384 point ops, paid for with 64
random 160-byte table rows per signature.  Whether that wins depends on
the card's gather cost, so the engine decides per process with a timed
profile (crypto/batch_verifier.py PubkeyTable._auto_tabulated).

Tables hold canonical int16 limbs in the JAX package's layout
[V*64*16, 4, 20] (160 KB per validator, 1.6 GB for 10k), so tables built
by either package carry across.

This module holds the plain versions (`build_window_tables_plain`,
`verify_tabulated_plain`) and the wrappers of kernels 2 and 3
(csrc/ed25519_table.cu): `build_window_tables` and `verify_tabulated` launch
the kernels on CUDA tensors and run the plain versions on CPU tensors.  A
build is two launches (pass A, the doubling chain, one quad per validator;
pass B, the 14 adds, one thread per (validator, window)); `BUILD_LAUNCHES`
counts one per build.  Kernel 3 spreads each signature's sum over two
quads of four lanes, each summing 32 windows of both halves, and takes the
base windows in madd form (`base_windows_madd`); it sums in another order
than the plain version, so its projective limbs differ, but its verdicts
and canonical R' do not.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import ed25519_math as em
from . import _build, _check, curve, fe
from .ed25519 import TWO_D, expand_digits, finish, identity

N = fe.N_LIMBS
N_WINDOWS = 64
N_DIGITS = 16

BUILD_LAUNCHES = 0
SUM_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def build_window_tables_plain(neg_a_rows: torch.Tensor) -> torch.Tensor:
    """[V, 4, 20] (any int dtype) extended −A -> [V*64*16, 4, 20] int16
    canonical window tables, bit-identical to the JAX package's
    _build_tables_jit (same adds and doublings in the same order)."""
    na = neg_a_rows.to(torch.int32).permute(1, 2, 0)  # [4, 20, V]
    v = na.shape[-1]
    dev = na.device
    two_d = fe.const(TWO_D, dev)
    ident = identity(v, dev)
    p = (na[0], na[1], na[2], na[3])
    windows = []
    for _ in range(N_WINDOWS):
        entries = [ident, p]
        m = p
        for _ in range(N_DIGITS - 2):
            m = curve.point_add(m, p, two_d)
            entries.append(m)
        stacked = torch.stack([torch.stack(e) for e in entries])  # [16, 4, 20, V]
        flat = stacked.permute(2, 0, 1, 3).reshape(N, -1)  # [20, 16*4*V]
        canon = curve.canonical(flat).reshape(N, N_DIGITS, 4, v).permute(1, 2, 0, 3)
        windows.append(canon.to(torch.int16))  # [16, 4, 20, V]
        for _ in range(4):
            p = curve.point_double(p)
    tab = torch.stack(windows)  # [64, 16, 4, 20, V]
    return tab.permute(4, 0, 1, 2, 3).reshape(v * N_WINDOWS * N_DIGITS, 4, N).contiguous()


def _build_base_windows() -> np.ndarray:
    """[64*16, 4, 20] int32: d·16^w·B in extended coords with Z=1 (the JAX
    package's base_windows, built by repeated addition instead of one
    scalar multiplication per entry; affine values are the same)."""
    rows = np.zeros((N_WINDOWS * N_DIGITS, 4, N), dtype=np.int32)
    one = fe.from_int(1)[:, 0]
    base_w = em.BASE
    for w in range(N_WINDOWS):
        rows[w * N_DIGITS, 1] = one
        rows[w * N_DIGITS, 2] = one
        pt = em.IDENTITY
        for d in range(1, N_DIGITS):
            pt = em.point_add(pt, base_w)
            x, y = em.to_affine(pt)
            rows[w * N_DIGITS + d, 0] = fe.from_int(x)[:, 0]
            rows[w * N_DIGITS + d, 1] = fe.from_int(y)[:, 0]
            rows[w * N_DIGITS + d, 2] = one
            rows[w * N_DIGITS + d, 3] = fe.from_int(x * y % em.P)[:, 0]
        for _ in range(4):
            base_w = em.point_double(base_w)
    return rows


@functools.lru_cache(maxsize=1)
def base_windows() -> np.ndarray:
    return _build_base_windows()


@functools.lru_cache(maxsize=1)
def base_windows_madd() -> np.ndarray:
    """[64*16, 3, 20] int32: base_windows() in kernel 3's madd form
    (y−x, y+x, 2d·x·y), canonical; entry d = 0 of each window is the
    identity's (1, 1, 0), as in ops/ed25519.py's BASE_TABLE."""
    ext = base_windows()
    rows = np.zeros((ext.shape[0], 3, N), dtype=np.int32)
    for e, (x_l, y_l, _, _) in enumerate(ext):
        x, y = fe.to_int(x_l), fe.to_int(y_l)
        for c, v in enumerate(((y - x) % em.P, (y + x) % em.P, 2 * em.D * x * y % em.P)):
            rows[e, c] = fe.from_int(v)[:, 0]
    return rows


def verify_tabulated_plain(
    tables: torch.Tensor,  # [V*64*16, 4, 20] int16
    idx: torch.Tensor,  # [B] int validator row per signature
    h_digits: torch.Tensor,  # [B, 64] 4-bit digits of h, MSB first
    s_digits: torch.Tensor,  # [B, 64] 4-bit digits of s, MSB first
    r_y_raw: torch.Tensor,  # [B, 20]
    r_sign: torch.Tensor,  # [B]
    want_r: bool = False,
):
    """Sum of the 64 gathered table points and 64 base-window points, then
    the same invert / canonicalize / compare as the ladder."""
    b = idx.shape[0]
    dev = tables.device
    warange = torch.arange(N_WINDOWS, dtype=torch.int64, device=dev)
    # digits arrive MSB-first (ladder order); table windows are LSB-first
    hd = h_digits.to(torch.int64).flip(1)
    sd = s_digits.to(torch.int64).flip(1)
    gidx_a = (idx.to(torch.int64)[:, None] * N_WINDOWS + warange) * N_DIGITS + hd
    pts_a = tables[gidx_a.reshape(-1)].to(torch.int32).reshape(b, N_WINDOWS, 4, N)
    base = fe.const(base_windows(), dev)
    pts_b = base[(warange * N_DIGITS + sd).reshape(-1)].reshape(b, N_WINDOWS, 4, N)
    pts = torch.cat([pts_a, pts_b], dim=1).permute(1, 2, 3, 0)  # [128, 4, 20, B]
    two_d = fe.const(TWO_D, dev)
    acc = identity(b, dev)
    for q in pts:
        acc = curve.point_add(acc, (q[0], q[1], q[2], q[3]), two_d)
    return finish(acc, r_y_raw, r_sign, want_r)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def build_window_tables(neg_a_rows: torch.Tensor) -> torch.Tensor:
    """[V, 4, 20] int16 −A rows -> [V*64*16, 4, 20] int16 window tables
    (kernel 2 on CUDA tensors, the plain version on CPU tensors)."""
    if neg_a_rows.device.type == "cpu":
        return build_window_tables_plain(neg_a_rows)
    global BUILD_LAUNCHES
    v = neg_a_rows.shape[0]
    _check.tensors(neg_a_rows.device, rows=(neg_a_rows, torch.int16, (v, 4, N)))
    out = torch.empty((v * N_WINDOWS * N_DIGITS, 4, N), dtype=torch.int16,
                      device=neg_a_rows.device)
    if v:
        with torch.cuda.device(neg_a_rows.device):  # the launch goes to the tensors' card
            rc = _build.lib().ed25519_window_tables_launch(
                neg_a_rows.data_ptr(), out.data_ptr(), v,
                torch.cuda.current_stream(neg_a_rows.device).cuda_stream,
            )
        _check.launched("ed25519_window_tables", rc)
        BUILD_LAUNCHES += 1
    return out


def verify_tabulated(
    tables: torch.Tensor,  # [V*64*16, 4, 20] int16
    idx: torch.Tensor,  # [B] int32
    h_le: torch.Tensor,  # [B, 32] uint8 little-endian h mod L
    s_le: torch.Tensor,  # [B, 32] uint8 little-endian s
    r_y: torch.Tensor,  # [B, 20] int16
    r_sign: torch.Tensor,  # [B] uint8
    want_r: bool = False,
):
    """[B] bool verdicts (and, with `want_r`, R' encodings) — kernel 3 on
    CUDA tensors, the plain version on CPU tensors."""
    if tables.device.type == "cpu":
        return verify_tabulated_plain(
            tables, idx, expand_digits(h_le), expand_digits(s_le), r_y, r_sign, want_r
        )
    global SUM_LAUNCHES
    batch = idx.shape[0]
    rows = tables.shape[0] // (N_WINDOWS * N_DIGITS)
    _check.tensors(
        tables.device,
        tables=(tables, torch.int16, (rows * N_WINDOWS * N_DIGITS, 4, N)),
        idx=(idx, torch.int32, (batch,)),
        h_le=(h_le, torch.uint8, (batch, 32)),
        s_le=(s_le, torch.uint8, (batch, 32)),
        r_y=(r_y, torch.int16, (batch, N)),
        r_sign=(r_sign, torch.uint8, (batch,)),
    )
    ok = torch.empty(batch, dtype=torch.uint8, device=tables.device)
    r_out = torch.empty((batch, 32), dtype=torch.uint8, device=tables.device) if want_r else None
    if batch:
        with torch.cuda.device(tables.device):
            rc = _build.lib().ed25519_tabulated_launch(
                tables.data_ptr(), idx.data_ptr(), h_le.data_ptr(), s_le.data_ptr(),
                r_y.data_ptr(), r_sign.data_ptr(),
                _check.device_const(base_windows_madd(), tables.device).data_ptr(),
                ok.data_ptr(), r_out.data_ptr() if want_r else None,
                rows, batch, torch.cuda.current_stream(tables.device).cuda_stream,
            )
        _check.launched("ed25519_tabulated", rc)
        SUM_LAUNCHES += 1
    if want_r:
        return ok.bool(), r_out
    return ok.bool()
