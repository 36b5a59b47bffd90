"""Kernel 1 wrapper: the fused gather + Straus-ladder verify
(csrc/ed25519_ladder.cu).

`verify_indexed` verifies signature i against pubkey row `idx[i]` of
`rows`.  On CUDA tensors it launches the kernel on the current stream of
the tensors' card, with that card made current for the launch; on
CPU tensors it runs the plain version (ops/ed25519.py) — the only reason it
ever does.  `LAUNCHES` counts kernel launches and nothing else.

The kernel runs one quad of four lanes per signature (csrc/ge_quad.cuh);
`quad_selftest` holds those four-lane point helpers against the one-lane
helpers of csrc/fe51.cuh on the card.  It is a check, not part of the path,
and counts no launch.
"""

from __future__ import annotations

import torch

from . import _build, _check
from .ed25519 import BASE_TABLE, verify_prepared_packed

LAUNCHES = 0


def verify_indexed(
    rows: torch.Tensor,  # [V, 4, 20] int16 extended coords of -A per validator
    idx: torch.Tensor,  # [B] int32 row per signature
    h_le: torch.Tensor,  # [B, 32] uint8 little-endian h mod L
    s_le: torch.Tensor,  # [B, 32] uint8 little-endian s
    r_y: torch.Tensor,  # [B, 20] int16 raw R y limbs
    r_sign: torch.Tensor,  # [B] uint8 R x-parity
    want_r: bool = False,
):
    """[B] bool verdicts (and, with `want_r`, the [B, 32] uint8 encoding
    of each computed R')."""
    if rows.device.type == "cpu":
        return verify_prepared_packed(rows[idx.long()], h_le, s_le, r_y, r_sign, want_r)
    global LAUNCHES
    batch = idx.shape[0]
    _check.tensors(
        rows.device,
        rows=(rows, torch.int16, (rows.shape[0], 4, 20)),
        idx=(idx, torch.int32, (batch,)),
        h_le=(h_le, torch.uint8, (batch, 32)),
        s_le=(s_le, torch.uint8, (batch, 32)),
        r_y=(r_y, torch.int16, (batch, 20)),
        r_sign=(r_sign, torch.uint8, (batch,)),
    )
    ok = torch.empty(batch, dtype=torch.uint8, device=rows.device)
    r_out = torch.empty((batch, 32), dtype=torch.uint8, device=rows.device) if want_r else None
    if batch:
        with torch.cuda.device(rows.device):  # the launch goes to the tensors' card
            rc = _build.lib().ed25519_ladder_launch(
                rows.data_ptr(), idx.data_ptr(), h_le.data_ptr(), s_le.data_ptr(),
                r_y.data_ptr(), r_sign.data_ptr(),
                _check.device_const(BASE_TABLE, rows.device).data_ptr(),
                ok.data_ptr(), r_out.data_ptr() if want_r else None,
                rows.shape[0], batch, torch.cuda.current_stream(rows.device).cuda_stream,
            )
        _check.launched("ed25519_ladder", rc)
        LAUNCHES += 1
    if want_r:
        return ok.bool(), r_out
    return ok.bool()


def quad_selftest(p_rows: torch.Tensor, q_rows: torch.Tensor, digits: torch.Tensor):
    """For n items on CUDA tensors (p_rows, q_rows [n, 4, 20] int16 points,
    digits [n] uint8): with P = 2·p_row and Q = 2·q_row, the one-lane and
    the quad forms of (2P, P + Q, P + base[digit]).  Returns (raw, canon):
    raw [2, n, 3, 4, 5] int64 (the radix-2^51 limbs' bits), canon
    [2, n, 3, 4, 20] int16 canonical limbs; index 0 one-lane, 1 quad."""
    n = digits.shape[0]
    _check.tensors(
        p_rows.device,
        p_rows=(p_rows, torch.int16, (n, 4, 20)),
        q_rows=(q_rows, torch.int16, (n, 4, 20)),
        digits=(digits, torch.uint8, (n,)),
    )
    raw = torch.empty((2, n, 3, 4, 5), dtype=torch.int64, device=p_rows.device)
    canon = torch.empty((2, n, 3, 4, 20), dtype=torch.int16, device=p_rows.device)
    if n:
        with torch.cuda.device(p_rows.device):
            rc = _build.lib().ed25519_quad_selftest_launch(
                p_rows.data_ptr(), q_rows.data_ptr(), digits.data_ptr(),
                _check.device_const(BASE_TABLE, p_rows.device).data_ptr(),
                raw.data_ptr(), canon.data_ptr(), n,
                torch.cuda.current_stream(p_rows.device).cuda_stream,
            )
        _check.launched("ed25519_quad_selftest", rc)
    return raw, canon
