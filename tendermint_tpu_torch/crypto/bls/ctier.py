"""C fast tier for the BLS12-381 pairing hot path.

Loads csrc/bls12_381.c via ctypes with the discipline of
`crypto/hostprep.py`: compiled on demand with the system toolchain into
the package's `_build/` directory, the `.so` named by source hash +
machine arch (a stale or cross-arch binary is a cache miss and gets
rebuilt; like hostprep, -march=native codegen assumes the artifact stays
on the host that built it), nothing committed to git, graceful fallback
to the pure-Python reference tier when no compiler is present (one
warning, once).

This is host code: the BLS tier verifies on the CPU, beside the card's
ed25519 kernels, exactly where the reference package runs it.

The boundary representation is the affine "blob": big-endian field bytes,
96 B for G1 (x‖y) and 192 B for G2 (x.c0‖x.c1‖y.c0‖y.c1), with the group
identity carried as the module-level `INF` sentinel — C entry points only
ever see finite points.  `scheme.py` drives this module with blobs end to
end (decompress → sum/mul → pairing check, zero Python bignum work on the
hot path); `pairing.py` converts its Jacobian int tuples at the edge so
every existing caller gets the fast tier behind unchanged signatures.

Because ctypes releases the GIL for the call, pairings run truly parallel
to the event loop — the held-GIL executor stalls the pure tier
forces on node stop paths disappear with the tier.

A bounded FIFO decompress memo keyed by the compressed pubkey bytes makes
the per-block cost of a stable validator set one cache hit per key: the
same 100 validators sign every block, so the subgroup-checked decompress
(the only remaining slow step) amortizes to zero exactly like the
scheme-side hash_to_g2 memo.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# group identity at the blob boundary (decompress result / sum result)
INF = object()


def bounded_put(cache: dict, key, value, cap: int) -> None:
    """Bounded-FIFO insert shared by every memo in the BLS subsystem
    (decompress blobs here; hash points, hash blobs and verify verdicts
    in scheme.py): at capacity, evict the oldest quarter."""
    if len(cache) >= cap:
        for k in list(cache)[: cap // 4]:
            cache.pop(k, None)
    cache[key] = value


_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_load_lock = threading.Lock()
# test/bench override: "pure" disables the C tier regardless of toolchain
_forced: Optional[str] = None


_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _csrc_path() -> str:
    return os.path.join(_PKG, "csrc")


def _build_path() -> str:
    path = os.path.join(_PKG, "_build")
    os.makedirs(path, exist_ok=True)
    return path


def _load_lib() -> Optional[ctypes.CDLL]:
    """Compile from the committed C source and load via ctypes; None when
    no toolchain is available (logged once — a node silently running the
    reference pairing is exactly what the warning exists for)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _load_lock:
        if _lib_tried:
            return _lib
        lib = None
        try:
            src = os.path.join(_csrc_path(), "bls12_381.c")
            with open(src, "rb") as f:
                src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
            arch = platform.machine() or "unknown"
            so = os.path.join(_build_path(), f"bls12_381-{arch}-{src_hash}.so")
            if not os.path.exists(so):
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_path())
                os.close(fd)
                try:
                    base = ["cc", "-O3", "-shared", "-fPIC", "-o", tmp, src]
                    try:
                        subprocess.run(
                            base[:2] + ["-march=native"] + base[2:],
                            check=True, capture_output=True, timeout=120,
                        )
                    except Exception:
                        subprocess.run(
                            base, check=True, capture_output=True, timeout=120
                        )
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):  # failed compile: no orphan temp
                        os.unlink(tmp)
            cdll = ctypes.CDLL(so)
            cdll.bls381_ready.restype = ctypes.c_int
            u8 = ctypes.c_char_p
            buf = ctypes.c_char_p
            cdll.bls381_g1_decompress.argtypes = [u8, buf]
            cdll.bls381_g1_decompress.restype = ctypes.c_int
            cdll.bls381_g2_decompress.argtypes = [u8, buf]
            cdll.bls381_g2_decompress.restype = ctypes.c_int
            cdll.bls381_g1_sum.argtypes = [u8, ctypes.c_uint64, buf]
            cdll.bls381_g1_sum.restype = ctypes.c_int
            cdll.bls381_g2_sum.argtypes = [u8, ctypes.c_uint64, buf]
            cdll.bls381_g2_sum.restype = ctypes.c_int
            cdll.bls381_g1_mul.argtypes = [u8, u8, buf]
            cdll.bls381_g1_mul.restype = ctypes.c_int
            cdll.bls381_g2_mul.argtypes = [u8, u8, buf]
            cdll.bls381_g2_mul.restype = ctypes.c_int
            cdll.bls381_pairing_check.argtypes = [u8, u8, ctypes.c_uint64]
            cdll.bls381_pairing_check.restype = ctypes.c_int
            cdll.bls381_pairing_product.argtypes = [u8, u8, ctypes.c_uint64, buf]
            cdll.bls381_pairing_product.restype = ctypes.c_int
            cdll.bls381_expand_xmd.argtypes = [
                u8, ctypes.c_uint64, u8, ctypes.c_uint64, buf, ctypes.c_uint64,
            ]
            cdll.bls381_expand_xmd.restype = ctypes.c_int
            cdll.bls381_hash_to_g2.argtypes = [
                u8, ctypes.c_uint64, u8, ctypes.c_uint64, buf,
            ]
            cdll.bls381_hash_to_g2.restype = ctypes.c_int
            # init derives every constant and self-checks the transcribed
            # prime against p == ((x-1)^2/3)·r + x; a failed check refuses
            # the tier rather than corrupting consensus crypto
            if cdll.bls381_ready() != 1:
                raise RuntimeError("bls12_381.c init self-check failed")
            lib = cdll
        except Exception as exc:
            logger.warning(
                "BLS12-381 C pairing tier unavailable (%s); falling back to "
                "the pure-Python reference tier (slow aggregate pairing "
                "checks)", exc,
            )
            lib = None
        _lib = lib
        _lib_tried = True
    return _lib


def set_forced(tier: Optional[str]) -> None:
    """Force tier selection for tests/bench: "pure" disables the C tier,
    None restores auto-detection."""
    global _forced
    if tier not in (None, "pure"):
        raise ValueError(f"unknown forced tier: {tier!r}")
    _forced = tier


def available() -> bool:
    return _forced != "pure" and _load_lib() is not None


def get():
    """THE tier-selection accessor (scheme.py and pairing.py both route
    through it): this module when the compiled tier is usable, else None."""
    import sys

    return sys.modules[__name__] if available() else None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load_lib()
    if lib is None or _forced == "pure":
        raise RuntimeError(
            "BLS12-381 C tier unavailable — check available() before calling"
        )
    return lib


# -- point/blob conversions -------------------------------------------------
# Blobs are big-endian affine coordinates (96 B G1 / 192 B G2); the curve
# module's Jacobian int tuples convert at the edge.  Decompress outputs
# have Z == 1, so the common conversions never pay a field inversion.


def g1_blob(pt):
    """Jacobian G1 int tuple -> blob (or INF)."""
    from . import curve

    if pt[2] == 0:
        return INF
    if pt[2] == 1:
        x, y = pt[0], pt[1]
    else:
        x, y = curve.g1_affine(pt)
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def g2_blob(pt):
    """Jacobian G2 tuple (Fp2 coords) -> blob (or INF)."""
    from . import curve
    from .fields import F2_ONE, f2_is_zero

    if f2_is_zero(pt[2]):
        return INF
    if pt[2] == F2_ONE:
        x, y = pt[0], pt[1]
    else:
        x, y = curve.g2_affine(pt)
    return (
        x[0].to_bytes(48, "big") + x[1].to_bytes(48, "big")
        + y[0].to_bytes(48, "big") + y[1].to_bytes(48, "big")
    )


def g1_point(blob) -> tuple:
    """Blob (or INF) -> Jacobian G1 int tuple."""
    from . import curve

    if blob is INF:
        return curve.G1_INF
    return (
        int.from_bytes(blob[:48], "big"),
        int.from_bytes(blob[48:], "big"),
        1,
    )


def g2_point(blob) -> tuple:
    from . import curve
    from .fields import F2_ONE

    if blob is INF:
        return curve.G2_INF
    return (
        (int.from_bytes(blob[:48], "big"), int.from_bytes(blob[48:96], "big")),
        (int.from_bytes(blob[96:144], "big"), int.from_bytes(blob[144:], "big")),
        F2_ONE,
    )


# -- decompress (with bounded memo for stable validator sets) ---------------

_G1_MEMO_MAX = 4096
_g1_memo: Dict[bytes, object] = {}


def g1_decompress(data: bytes):
    """48-byte compressed G1 -> blob, INF, or None (curve/subgroup checked,
    identical accept/reject set to curve.g1_decompress)."""
    lib = _lib_or_raise()
    if len(data) != 48:
        return None
    out = ctypes.create_string_buffer(96)
    rc = lib.bls381_g1_decompress(bytes(data), out)
    if rc == 1:
        return out.raw
    return INF if rc == 2 else None


def g1_decompress_cached(data: bytes):
    key = bytes(data)
    hit = _g1_memo.get(key)
    if hit is None and key not in _g1_memo:
        hit = g1_decompress(key)
        bounded_put(_g1_memo, key, hit, _G1_MEMO_MAX)
    return hit


def g2_decompress(data: bytes):
    lib = _lib_or_raise()
    if len(data) != 96:
        return None
    out = ctypes.create_string_buffer(192)
    rc = lib.bls381_g2_decompress(bytes(data), out)
    if rc == 1:
        return out.raw
    return INF if rc == 2 else None


# -- group ops --------------------------------------------------------------


def g1_sum(blobs: Sequence[bytes]):
    """Sum of finite affine blobs -> blob or INF."""
    if not blobs:
        return INF
    lib = _lib_or_raise()
    out = ctypes.create_string_buffer(96)
    rc = lib.bls381_g1_sum(b"".join(blobs), len(blobs), out)
    if rc < 0:
        raise ValueError("bad G1 blob")
    return out.raw if rc == 1 else INF


def g2_sum(blobs: Sequence[bytes]):
    if not blobs:
        return INF
    lib = _lib_or_raise()
    out = ctypes.create_string_buffer(192)
    rc = lib.bls381_g2_sum(b"".join(blobs), len(blobs), out)
    if rc < 0:
        raise ValueError("bad G2 blob")
    return out.raw if rc == 1 else INF


def _scalar_bytes(k: int) -> Optional[bytes]:
    """Scalar -> canonical 32-byte big-endian (mod r; valid for subgroup
    points, which is all this tier ever handles).  None when k ≡ 0."""
    from .fields import R

    k %= R
    if k == 0:
        return None
    return k.to_bytes(32, "big")


def g1_mul(blob, k: int):
    """[k]P for a blob (or INF) -> blob or INF."""
    if blob is INF:
        return INF
    sc = _scalar_bytes(k)
    if sc is None:
        return INF
    lib = _lib_or_raise()
    out = ctypes.create_string_buffer(96)
    rc = lib.bls381_g1_mul(bytes(blob), sc, out)
    if rc < 0:
        raise ValueError("bad G1 blob")
    return out.raw if rc == 1 else INF


def g2_mul(blob, k: int):
    if blob is INF:
        return INF
    sc = _scalar_bytes(k)
    if sc is None:
        return INF
    lib = _lib_or_raise()
    out = ctypes.create_string_buffer(192)
    rc = lib.bls381_g2_mul(bytes(blob), sc, out)
    if rc < 0:
        raise ValueError("bad G2 blob")
    return out.raw if rc == 1 else INF


# -- hash-to-curve ----------------------------------------------------------
# RFC 9380 SVDW random-oracle hash, entirely in C (expand_message_xmd,
# hash_to_field, map, clear cofactor).  Output blobs are BIT-IDENTICAL to
# hash_to_curve.hash_to_g2 — every root/sign choice in the C map replicates
# the pure functions, and the differential suite pins it.


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd/SHA-256, C path."""
    lib = _lib_or_raise()
    if len_in_bytes == 0:
        # the C entry writes nothing for a zero-length request
        ell_probe = lib.bls381_expand_xmd(b"", 0, bytes(dst), len(dst), b"", 0)
        if ell_probe != 1:
            raise ValueError("expand_message_xmd failed")
        return b""
    out = ctypes.create_string_buffer(len_in_bytes)
    rc = lib.bls381_expand_xmd(
        bytes(msg), len(msg), bytes(dst), len(dst), out, len_in_bytes
    )
    if rc != 1:
        raise ValueError("len_in_bytes too large for xmd")
    return out.raw


def hash_to_g2_blob(msg: bytes, dst: bytes):
    """hash_to_g2(msg, dst) -> affine blob (or INF), C path end to end."""
    lib = _lib_or_raise()
    out = ctypes.create_string_buffer(192)
    rc = lib.bls381_hash_to_g2(bytes(msg), len(msg), bytes(dst), len(dst), out)
    if rc == 1:
        return out.raw
    if rc == 0:
        return INF
    raise ValueError("hash_to_g2 failed")


# -- pairing ----------------------------------------------------------------


def pairing_check(pairs: Sequence[Tuple[bytes, bytes]]) -> bool:
    """True iff Π e(Pᵢ, Qᵢ) == 1 over finite affine blob pairs (identity
    operands must already be filtered — they contribute the neutral 1)."""
    if not pairs:
        return True
    lib = _lib_or_raise()
    rc = lib.bls381_pairing_check(
        b"".join(p for p, _ in pairs), b"".join(q for _, q in pairs), len(pairs)
    )
    if rc < 0:
        raise ValueError("bad pairing operand")
    return rc == 1


def _filter_pairs(pairs) -> Optional[List[Tuple[bytes, bytes]]]:
    """Jacobian point pairs -> finite blob pairs, dropping identity
    operands exactly like pairing.pairing_product does."""
    out = []
    for g1pt, g2pt in pairs:
        pb = g1_blob(g1pt)
        qb = g2_blob(g2pt)
        if pb is INF or qb is INF:
            continue
        out.append((pb, qb))
    return out


def pairing_check_points(pairs) -> bool:
    """pairing.pairing_check for Jacobian int-tuple pairs."""
    return pairing_check(_filter_pairs(pairs))


def pairing_product_points(pairs) -> tuple:
    """pairing.pairing_product for Jacobian pairs — returns the same
    nested Fp12 tuple (bit-identical to the pure tier: same HHT final
    exponentiation, line scalings killed by it)."""
    from .fields import F12_ONE

    blobs = _filter_pairs(pairs)
    if not blobs:
        return F12_ONE
    lib = _lib_or_raise()
    out = ctypes.create_string_buffer(576)
    rc = lib.bls381_pairing_product(
        b"".join(p for p, _ in blobs), b"".join(q for _, q in blobs), len(blobs), out
    )
    if rc != 1:
        raise ValueError("bad pairing operand")
    raw = out.raw
    coords = [int.from_bytes(raw[48 * i : 48 * i + 48], "big") for i in range(12)]
    f2s = [(coords[2 * i], coords[2 * i + 1]) for i in range(6)]
    return ((f2s[0], f2s[1], f2s[2]), (f2s[3], f2s[4], f2s[5]))
