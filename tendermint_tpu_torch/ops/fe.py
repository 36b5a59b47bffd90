"""GF(2^255-19) field arithmetic on 20 x 13-bit limbs in torch int32 — the
plain (reference) field layer of the port.

Mirrors tendermint_tpu/ops/fe.py limb for limb: a field element is an
[N_LIMBS, B] int32 tensor (limb-major, batch last), carries propagate in
the same carry-save passes, and subtraction adds the same 64p bias, so every
intermediate is bit-identical to the JAX package's.  The CUDA kernels
(csrc/*.cu) do not use this representation internally (they work in radix
2^51 with 64-bit products); they read and write these 13-bit limbs at their
boundaries, and the tests hold them to this module's results.

Magnitude analysis (invariant: limbs <= 10016 between operations):
  mul conv:   coeff <= 20 * 10016^2           = 2.007e9 < 2^31 - 1  exact
  add out:    <= 8191 + 608*2  = 9407  <= 10016
  sub out:    <= 8191 + 608*3  = 10015 <= 10016  (bias = 64p, below)
  mul out:    <= 8799 (row 0) / 8237 (rest)    <= 10016

Folding: 2^260 ≡ 2^5·19 = 608 (mod p), and for the transient 41st
convolution row 2^520 ≡ 608² = 369664.
"""

from __future__ import annotations

import numpy as np
import torch

N_LIMBS = 20
LIMB_BITS = 13
MASK = (1 << LIMB_BITS) - 1
P_INT = 2**255 - 19
FOLD = 608  # 2^260 mod p
FOLD2 = FOLD * FOLD  # 2^520 mod p


def from_int(v: int) -> np.ndarray:
    """python int -> [N_LIMBS, 1] int32 constant (broadcasts over batch)."""
    return np.array(
        [[(v >> (LIMB_BITS * i)) & MASK] for i in range(N_LIMBS)], dtype=np.int32
    )


def to_int(x, lane: int = 0) -> int:
    """Host helper for tests: lane `lane` of a [N_LIMBS, B] array -> int."""
    arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if arr.ndim == 1:
        arr = arr[:, None]
    return sum(int(arr[i, lane]) << (LIMB_BITS * i) for i in range(N_LIMBS))


P_LIMBS = from_int(P_INT)


def _bias_limbs() -> np.ndarray:
    """Per-limb decomposition of 64p with every limb in [15168, 16382]."""
    d = 64 * P_INT - (2**260 - 1)  # distribute 8191 to every limb first
    digits = [(d >> (LIMB_BITS * i)) & MASK for i in range(N_LIMBS)]
    bias = np.array([[8191 + dig] for dig in digits], dtype=np.int32)
    assert sum(int(b) << (LIMB_BITS * i) for i, b in enumerate(bias[:, 0])) == 64 * P_INT
    return bias


BIAS_64P = _bias_limbs()

_const_cache: dict = {}


def const(c: np.ndarray, device) -> torch.Tensor:
    """A numpy constant as an int32 tensor on `device`, cached."""
    key = (id(c), str(device))
    t = _const_cache.get(key)
    if t is None:
        t = torch.as_tensor(c, dtype=torch.int32, device=device)
        _const_cache[key] = t
    return t


def broadcast_const(c: np.ndarray, batch: int, device) -> torch.Tensor:
    return const(c, device).expand(N_LIMBS, batch)


def _cs_pass(v: torch.Tensor, top_fold: int = FOLD) -> torch.Tensor:
    """One carry-save pass: extract carries, shift them up one limb, fold
    the top limb's carry back via `top_fold` (its weight mod p)."""
    carry = v >> LIMB_BITS
    out = v & MASK
    out[1:] += carry[:-1]
    out[0] += top_fold * carry[-1]
    return out


def add(a, b):
    return _cs_pass(a + b)


def sub(a, b):
    return _cs_pass(a + const(BIAS_64P, a.device) - b)


def _reduce_conv(c: torch.Tensor) -> torch.Tensor:
    """[39, B] convolution coefficients (<= 2.11e9) -> [20, B] limbs
    within the <= 10016 invariant (same passes as the JAX package)."""
    c = torch.cat([c, c.new_zeros((41 - c.shape[0],) + c.shape[1:])], dim=0)
    c = _cs_pass(c, top_fold=FOLD2)
    c = _cs_pass(c, top_fold=FOLD2)
    c = _cs_pass(c, top_fold=FOLD2)
    lo = c[:N_LIMBS] + FOLD * c[N_LIMBS : 2 * N_LIMBS]
    lo[0] += FOLD2 * c[2 * N_LIMBS]
    lo = _cs_pass(lo)
    return _cs_pass(lo)


def _conv(a, b):
    """[20, B] x [20, B] -> [39, B] limb convolution: the [20, 20, B] outer
    product padded to [20, 40, B] and flattened so row i lands shifted right
    by i; summing rows yields c_k = sum_{i+j=k} a_i b_j."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[1:]
    p = a[:, None] * b[None, :]  # [20, 20, B]
    p = torch.cat([p, p.new_zeros(p.shape)], dim=1)  # [20, 40, B]
    flat = p.reshape((2 * N_LIMBS * N_LIMBS,) + batch)[: N_LIMBS * (2 * N_LIMBS - 1)]
    return flat.reshape((N_LIMBS, 2 * N_LIMBS - 1) + batch).sum(dim=0, dtype=torch.int32)


def mul(a, b):
    """Schoolbook limb convolution; exact in int32 per the header analysis."""
    return _reduce_conv(_conv(a, b))


def square(a):
    return _reduce_conv(_conv(a, a))


def canonical(x):
    """Full reduction to [0, p): delegates to the curve layer (one copy of
    the consensus-critical normalization)."""
    from . import curve

    return curve.canonical(x)


def invert(z):
    """z^(p-2): delegates to the addition chain in ops/curve.py."""
    from . import curve

    return curve.invert(z)


def eq(a, b) -> torch.Tensor:
    """Limb-wise equality (callers canonicalize first); [B] bool."""
    return (a == b).all(dim=0)
