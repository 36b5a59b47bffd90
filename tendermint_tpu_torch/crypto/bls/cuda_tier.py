"""The batched BLS12-381 multi-point fold on the card: the tier behind
`scheme._sum_g1/_sum_g2` (the Σpk / Σsig of the pure lanes' aggregate
checks) when `scheme.set_jax_aggregation(True)` turned it on.

The port's counterpart of tendermint_tpu/crypto/bls/jax_tier.py.  The host
prep is JAX's: each coordinate in Montgomery form (R = 2^384) as 48 8-bit
limbs in int32, [bucket, 3, 48] rows for G1 and [bucket, 3, 2, 48] for G2,
zero-padded to a power-of-two bucket (all-zero rows are the identity,
Z = 0).  The sum runs as a binary tree of complete point additions in
ops/bls12_381_fold.py: the CUDA kernels of csrc/bls12_381_fold.cu on the
card, their plain torch version on the CPU.  For the same points the
Jacobian triple equals jax_tier's, limb for limb.

With a mesh (crypto/backend.py `Mesh`) of a power-of-two count m of
shards the fold is sharded as jax_tier shards it: the bucket grows to a
multiple of m (`_mesh_bucket`), shard k folds the aligned subtree of rows
[k·b/m, (k+1)·b/m) with the same kernel on its own stream, and the m roots,
copied to the mesh's first device, fold as a bucket of m.  That is _tree's
association, so the triple stays limb-equal to jax_tier's sharded jit.  A
one-row shard's root is its row, with no launch.  Any other mesh folds on
its first device, unsharded, as jax_tier's does.

Unlike jax_tier, which returns None on any failure so that the scheme
folds on the host, a failed build, launch or device raises here, on any
shard.  The pure tier (`curve.py`) stays the differential oracle.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .fields import P

NL = 48  # limbs per Fp element
RADIX = 8
MASK = (1 << RADIX) - 1
MIN_BATCH = 8  # below this the pure-python fold serves (the scheme's rule)

_R = 1 << (NL * RADIX)  # Montgomery R = 2^384
_RINV = pow(_R, P - 2, P)


def available() -> bool:
    """True where the fold can run on a card (CUDA is available)."""
    import torch

    return torch.cuda.is_available()


def _int_to_limbs(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(NL, "little"), dtype=np.uint8).astype(np.int32)


def _limbs_to_int(a) -> int:
    return int.from_bytes(bytes(np.asarray(a, dtype=np.int32).astype(np.uint8)), "little")


def _to_mont(x: int) -> int:
    return (x * _R) % P


def _from_mont(x: int) -> int:
    return (x * _RINV) % P


def _bucket(n: int) -> int:
    """The tree's bucket for n points: the next power of two, at least 2
    (jax_tier._mesh_bucket without a mesh)."""
    b = 2
    while b < n:
        b *= 2
    return b


def _mesh_bucket(n: int, mesh):
    """(bucket, mesh to shard over or None) for a fold of n points, by
    jax_tier._mesh_bucket's rule: a power-of-two mesh of m >= 2 shards
    grows the bucket to a multiple of m; any other mesh folds unsharded."""
    b = _bucket(n)
    if mesh is None:
        return b, None
    m = mesh.size
    if m < 2 or m & (m - 1):
        return b, None
    while b % m:
        b *= 2
    return b, mesh


def _rows(coords, n: int, shape, bucket: Optional[int] = None) -> np.ndarray:
    """[bucket, *shape] int32 rows (bucket: _bucket(n) unless given): the
    Montgomery limbs of `coords` (ints in row order), zero rows after the n
    points."""
    flat = b"".join(_to_mont(c % P).to_bytes(NL, "little") for c in coords)
    rows = np.zeros((bucket or _bucket(n),) + shape, dtype=np.int32)
    rows.reshape(-1)[: len(flat)] = np.frombuffer(flat, dtype=np.uint8)
    return rows


def g1_rows(pts: Sequence[Tuple[int, int, int]], bucket: Optional[int] = None) -> np.ndarray:
    """The [bucket, 3, 48] rows jax_tier.aggregate_g1 builds."""
    return _rows((c for pt in pts for c in pt), len(pts), (3, NL), bucket)


def g2_rows(pts, bucket: Optional[int] = None) -> np.ndarray:
    """The [bucket, 3, 2, 48] rows jax_tier.aggregate_g2 builds."""
    return _rows((c for pt in pts for coord in pt for c in coord), len(pts), (3, 2, NL), bucket)


def g1_point(out) -> Tuple[int, int, int]:
    """A fold's [3, 48] output (a tensor or array) -> Jacobian G1 ints."""
    out = np.asarray(out.cpu() if hasattr(out, "cpu") else out)
    return tuple(_from_mont(_limbs_to_int(out[i])) for i in range(3))


def g2_point(out) -> tuple:
    """A fold's [3, 2, 48] output -> Jacobian G2 (Fp2 coords as int pairs)."""
    out = np.asarray(out.cpu() if hasattr(out, "cpu") else out)
    return tuple((_from_mont(_limbs_to_int(out[i, 0])), _from_mont(_limbs_to_int(out[i, 1])))
                 for i in range(3))


def resolve_device(device):
    """None means the card, which raises where there is none; the CPU
    only when asked for."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to fold with the "
                           "plain torch version")
    return dev


def _fold(rows: np.ndarray, fold, mesh, device):
    """The sum of the rows by `fold` (ops/bls12_381_fold.fold_g1 or
    fold_g2): sharded over `mesh` when _mesh_bucket takes it, else on the
    mesh's first device (which a named `device` must be), or on `device`
    without a mesh."""
    import torch

    first = mesh.lead(device) if mesh is not None else resolve_device(device)
    bucket, sharded = _mesh_bucket(rows.shape[0], mesh)
    if sharded is None:
        return fold(torch.as_tensor(rows, device=first))
    q = bucket // mesh.size
    host = torch.from_numpy(rows)
    if first.type == "cuda":  # pinned: each shard's upload runs without blocking the host
        host = host.pin_memory()
    roots = []
    for k, dev in enumerate(mesh.devices):
        with mesh.on_shard(k) as stream:
            part = host[k * q:(k + 1) * q].to(dev, non_blocking=True)
            roots.append((fold(part) if q > 1 else part[0], dev, stream))
    gathered = []
    for root, dev, stream in roots:
        if stream is not None:
            # the copy to the first device and the root fold run after the
            # shard's fold, on the devices' current streams
            for d in (dev, first):
                torch.cuda.current_stream(d).wait_stream(stream)
            root.record_stream(torch.cuda.current_stream(dev))
        gathered.append(root.to(first))
    return fold(torch.stack(gathered))


def aggregate_g1(pts: Sequence[Tuple[int, int, int]], mesh=None,
                 device=None) -> Optional[Tuple[int, int, int]]:
    """Σ of Jacobian G1 points by the fold, over `mesh` or on `device`
    (None: the card); None for no points, as jax_tier."""
    from ...ops import bls12_381_fold

    if not pts:
        return None
    rows = g1_rows(pts, _mesh_bucket(len(pts), mesh)[0])
    return g1_point(_fold(rows, bls12_381_fold.fold_g1, mesh, device))


def aggregate_g2(pts, mesh=None, device=None) -> Optional[tuple]:
    """Σ of Jacobian G2 points (Fp2 coords as int pairs) by the fold, over
    `mesh` or on `device` (None: the card); None for no points, as
    jax_tier."""
    from ...ops import bls12_381_fold

    if not pts:
        return None
    rows = g2_rows(pts, _mesh_bucket(len(pts), mesh)[0])
    return g2_point(_fold(rows, bls12_381_fold.fold_g2, mesh, device))
