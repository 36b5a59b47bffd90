"""Kernel 1 wrapper: the fused gather + Straus-ladder verify
(csrc/ed25519_ladder.cu).

`verify_indexed` verifies signature i against pubkey row `idx[i]` of
`rows`.  On CUDA tensors it launches the kernel on the current stream; on
CPU tensors it runs the plain version (ops/ed25519.py) — the only reason it
ever does.  `LAUNCHES` counts kernel launches and nothing else.
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
