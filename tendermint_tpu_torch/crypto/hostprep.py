"""Accelerated host-side batch preparation.

The per-signature host work feeding the GPU kernels (SHA-512 of R‖A‖M,
scalar mod-L reduction, 13-bit limb packing of R, canonical-S check).
This module provides:

- a batch SHA-512 C extension (csrc/sha512_batch.c), compiled on demand
  with the system toolchain into the package's `_build/` directory and
  loaded via ctypes (no Python.h / pybind11
  dependency), with a hashlib fallback when no compiler is present;
- a fused one-pass `prep_scalar_rows`: hash + Barrett mod-L + 4-bit digit
  extraction + 13-bit R-limb packing + canonical-S prefilter all emitted
  kernel-ready from a single threaded C loop (no intermediate numpy
  arrays) — the host-prep side of the verify hot path;
- numpy-vectorized R-limb packing and canonical-S checks as the
  no-toolchain fallback for the same outputs.

The numpy pipeline is the differential reference the tests hold the C
path against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np

from . import ed25519_math as em

_N = 20
_BITS = 13

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csrc_path() -> str:
    return os.path.join(_PKG, "csrc")


def _build_path() -> str:
    path = os.path.join(_PKG, "_build")
    os.makedirs(path, exist_ok=True)
    return path


def _load_lib() -> Optional[ctypes.CDLL]:
    """Compile from the committed C source and load via ctypes; None when no
    toolchain is available.  The artifact name embeds the source SHA-256, so
    only a binary built from exactly this source can ever be loaded — a
    stale, foreign, or wrong-arch .so (never committed to git) is simply a
    cache miss and gets rebuilt."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    src = os.path.join(_csrc_path(), "sha512_batch.c")
    try:
        with open(src, "rb") as f:
            src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_build_path(), f"sha512_batch-{src_hash}.so")
        if not os.path.exists(so):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_path())
            os.close(fd)
            base = ["cc", "-O3", "-shared", "-fPIC", "-pthread", "-o", tmp, src]
            # -march=native buys ~20% on the SHA-512 compression loop; fall
            # back for toolchains that reject it.  The artifact is per-host
            # (hash-named, never committed), so native codegen is safe.
            try:
                subprocess.run(
                    base[:2] + ["-march=native"] + base[2:],
                    check=True, capture_output=True, timeout=60,
                )
            except Exception:
                subprocess.run(base, check=True, capture_output=True, timeout=60)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        argtypes = [ctypes.c_char_p, u64p, ctypes.c_uint64, u8p]
        lib.sha512_mod_l_batch.argtypes = argtypes
        lib.sha512_mod_l_batch.restype = None
        # one-pass kernel-ready prep (threaded)
        lib.ed25519_prep_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, u64p, u8p,
            ctypes.c_uint64, u8p, u8p, i16p, u8p, u8p, ctypes.c_int,
        ]
        lib.ed25519_prep_batch.restype = None
        # serial host path (crypto.batch.host_batch_verify, keys.py)
        lib.ed25519_verify.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p
        ]
        lib.ed25519_verify.restype = ctypes.c_int
        lib.ed25519_verify_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, u64p, ctypes.c_char_p,
            ctypes.c_uint64, u8p,
        ]
        lib.ed25519_verify_batch.restype = None
        # signing and key derivation (keys.py): the uint64_t length params
        # MUST be declared — without argtypes ctypes marshals Python ints
        # as 32-bit c_int into 64-bit slots (UB; garbage upper bits on
        # ABIs that don't zero-extend narrow args)
        lib.ed25519_sign.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p,
        ]
        lib.ed25519_sign.restype = None
        lib.ed25519_pubkey.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.ed25519_pubkey.restype = None
        # the secret connection's AEAD (crypto/backend.py)
        lib.chacha20poly1305_seal.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
        ]
        lib.chacha20poly1305_seal.restype = None
        lib.chacha20poly1305_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
        ]
        lib.chacha20poly1305_open.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _lib = None
    return _lib


_PREP_THREADS = min(os.cpu_count() or 1, 8)


def have_fast_prep() -> bool:
    return _load_lib() is not None


def prep_scalar_rows(items) -> Optional[tuple]:
    """One C pass from raw (pubkey, msg, sig) triples to kernel-ready
    arrays: (h_digits [n,64] u8, s_digits [n,64] u8, r_y [n,20] i16,
    r_sign [n] u8, valid [n] bool).  `items[i]` is a triple or None for
    entries the caller already knows are invalid (emitted as zeros).
    Returns None when the C extension is unavailable (caller falls back
    to the numpy path)."""
    lib = _load_lib()
    if lib is None:
        return None
    n = len(items)
    zeros64 = bytes(64)
    zeros32 = bytes(32)
    empty = b""
    sig_parts: list = [zeros64] * n
    pk_parts: list = [zeros32] * n
    msg_parts: list = [empty] * n
    skip = np.ones(n, dtype=np.uint8)
    lens = np.zeros(n, dtype=np.uint64)
    for i, item in enumerate(items):
        if item is None:
            continue
        pk, msg, sig = item
        if len(sig) != 64 or len(pk) != 32:
            continue
        sig_parts[i] = sig
        pk_parts[i] = pk
        msg_parts[i] = msg
        lens[i] = len(msg)
        skip[i] = 0
    offs = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(lens, out=offs[1:])
    h_digits = np.empty((n, 64), dtype=np.uint8)
    s_digits = np.empty((n, 64), dtype=np.uint8)
    r_y = np.empty((n, 20), dtype=np.int16)
    r_sign = np.empty(n, dtype=np.uint8)
    valid = np.empty(n, dtype=np.uint8)
    lib.ed25519_prep_batch(
        b"".join(sig_parts), b"".join(pk_parts), b"".join(msg_parts),
        offs, skip, n, h_digits, s_digits, r_y, r_sign, valid,
        _PREP_THREADS,
    )
    return h_digits, s_digits, r_y, r_sign, valid.astype(bool)


def host_verify_batch(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
) -> Optional[List[bool]]:
    """Serial C host verify for a whole batch (one ctypes call instead of
    n).  None when the C extension is unavailable."""
    lib = _load_lib()
    if lib is None:
        return None
    n = len(sigs)
    zeros64 = bytes(64)
    zeros32 = bytes(32)
    sig_parts: list = [zeros64] * n
    pk_parts: list = [zeros32] * n
    msg_parts: list = [b""] * n
    bad = []
    lens = np.zeros(n, dtype=np.uint64)
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        if len(pk) != 32 or len(sig) != 64:
            bad.append(i)
            continue
        pk_parts[i] = pk
        sig_parts[i] = sig
        msg_parts[i] = msg
        lens[i] = len(msg)
    offs = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(lens, out=offs[1:])
    out = np.empty(n, dtype=np.uint8)
    lib.ed25519_verify_batch(
        b"".join(pk_parts), b"".join(msg_parts), offs, b"".join(sig_parts), n, out
    )
    res = out.astype(bool)
    for i in bad:
        res[i] = False
    return res.tolist()


def sha512_mod_l(parts: Sequence[bytes]) -> np.ndarray:
    """[n, 32] uint8 little-endian h = SHA-512(item) mod L per item — the
    whole hash+reduce host step in one C pass (Barrett, see sha512_batch.c);
    hashlib + Python-int fallback without a toolchain."""
    n = len(parts)
    lib = _load_lib()
    if lib is None:
        out = np.empty((n, 32), dtype=np.uint8)
        for i, p in enumerate(parts):
            h = int.from_bytes(hashlib.sha512(p).digest(), "little") % em.L
            out[i] = np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)
        return out
    buf = b"".join(parts)
    offs = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(p) for p in parts], out=offs[1:])
    out = np.empty((n, 32), dtype=np.uint8)
    lib.sha512_mod_l_batch(buf, offs, n, out)
    return out


# -- vectorized packing helpers --------------------------------------------

# byte/shift positions contributing to each 13-bit limb of a 256-bit LE value
_LIMB_BYTE = [(_BITS * i) // 8 for i in range(_N)]
_LIMB_SHIFT = [(_BITS * i) % 8 for i in range(_N)]

_L_BYTES_BE = np.frombuffer(em.L.to_bytes(32, "big"), dtype=np.uint8)


def limbs_from_le_bytes(rows: np.ndarray) -> np.ndarray:
    """[n, 32] LE byte rows -> [n, 20] int16 13-bit limbs (low 255 bits)."""
    n = rows.shape[0]
    r32 = rows.astype(np.uint32)
    padded = np.zeros((n, 34), dtype=np.uint32)
    padded[:, :32] = r32
    out = np.empty((n, _N), dtype=np.int16)
    for i in range(_N):
        b, sh = _LIMB_BYTE[i], _LIMB_SHIFT[i]
        v = padded[:, b] | (padded[:, b + 1] << 8) | (padded[:, b + 2] << 16)
        if i == _N - 1:
            # top limb: only bits up to 254 (bit 255 is the sign bit)
            out[:, i] = ((v >> sh) & ((1 << _BITS) - 1) & 0xFF).astype(np.int16)
        else:
            out[:, i] = ((v >> sh) & ((1 << _BITS) - 1)).astype(np.int16)
    return out


def sign_bits(rows: np.ndarray) -> np.ndarray:
    """[n, 32] LE byte rows -> [n] uint8 bit 255."""
    return (rows[:, 31] >> 7).astype(np.uint8)


def sc_minimal_rows(s_rows: np.ndarray) -> np.ndarray:
    """[n, 32] LE scalar byte rows -> [n] bool s < L (canonical-S,
    vectorized equivalent of ed25519_math.sc_minimal)."""
    be = s_rows[:, ::-1]  # big-endian for lexicographic compare
    diff = be != _L_BYTES_BE[None, :]
    first = np.argmax(diff, axis=1)
    any_diff = diff.any(axis=1)
    rows_idx = np.arange(s_rows.shape[0])
    less = be[rows_idx, first] < _L_BYTES_BE[first]
    return np.where(any_diff, less, False)  # s == L is not minimal
