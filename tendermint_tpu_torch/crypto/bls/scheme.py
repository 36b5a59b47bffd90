"""BLS min-pk signature scheme (draft-irtf-cfrg-bls-signature shape):
pubkeys in G1 (48B compressed), signatures in G2 (96B compressed),
proof-of-possession variant — FastAggregateVerify is only sound for
PoP-checked key sets, which the validator-set plumbing enforces at
genesis/valset-update time.

Every verification bottoms out in `pairing.pairing_check` — ONE
pairing-product with a shared final exponentiation.  `batch_verify_
aggregates` folds k independent aggregate checks into a single product
using random blinding scalars (Fiat–Shamir-free batching: a forged item
survives with probability ~2⁻⁶⁴ per batch; failures fall back to
per-item checks so the caller still learns WHICH item lied).

A small result memo keyed by (pubkeys-digest, msg, sig) lets async
pre-verification lanes (statesync/lite2) warm the synchronous
verify_commit path without re-pairing.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from typing import Dict, List, Optional, Sequence, Tuple

from . import cuda_tier, curve, hash_to_curve
from .ctier import bounded_put
from .fields import R

# Suite DSTs (see hash_to_curve.py header for why SVDW, not SSWU)
DST_SIG = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SVDW_RO_POP_"
DST_POP = b"BLS_POP_BLS12381G2_XMD:SHA-256_SVDW_RO_POP_"

PUBKEY_SIZE = 48
SIGNATURE_SIZE = 96


# -- tier selection ---------------------------------------------------------
# Every entry point below prefers the compiled pairing tier
# (csrc/bls12_381.c via ctier — decompress/sum/mul/pairing all in C, GIL
# released for the call) and falls back to the pure tower, which stays
# the differential reference.  Verdicts are identical by construction and
# pinned by the differential suite; only wall time differs (far less in C
# per aggregate check).


def _ctier():
    from . import ctier

    return ctier.get()


def active_tier() -> str:
    """Which pairing tier verification runs on: "c" (compiled fast tier)
    or "pure" (reference tower).  The `crypto.backend.active_tier()`
    analogue for BLS — exported as the `tendermint_verify_bls_tier` gauge
    and stamped on `verify.bls_agg` recorder events so bench numbers and
    production telemetry agree on which tier actually ran."""
    return "c" if _ctier() is not None else "pure"


def _neg_g1_gen_blob(ct):
    """Cached affine blob of -g1 (the constant in every verify equation)."""
    global _NEG_G1_BLOB
    if _NEG_G1_BLOB is None:
        _NEG_G1_BLOB = ct.g1_blob(curve.g1_neg(curve.G1_GEN))
    return _NEG_G1_BLOB


_NEG_G1_BLOB = None


# -- keygen -----------------------------------------------------------------


def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """HKDF-based KeyGen (draft §2.3): deterministic sk ∈ [1, r-1]."""
    if len(ikm) < 32:
        raise ValueError("ikm must be at least 32 bytes")
    salt = b"BLS-SIG-KEYGEN-SALT-"
    while True:
        salt = hashlib.sha256(salt).digest()
        prk = hmac.new(salt, ikm + b"\x00", hashlib.sha256).digest()
        okm = b""
        t = b""
        info = key_info + (48).to_bytes(2, "big")
        for i in range(1, 3):
            t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
            okm += t
        sk = int.from_bytes(okm[:48], "big") % R
        if sk != 0:
            return sk


def generate() -> int:
    return keygen(os.urandom(32))


def sk_to_pk(sk: int) -> bytes:
    ct = _ctier()
    if ct is not None:
        out = ct.g1_mul(ct.g1_blob(curve.G1_GEN), sk)
        return curve.g1_compress(ct.g1_point(out))
    return curve.g1_compress(curve.g1_mul(curve.G1_GEN, sk))


# -- core sign/verify -------------------------------------------------------


# hash_to_g2 memo: consensus verifies many signatures over the SAME
# message (every precommit for a block signs identical timestamp-free
# bytes), so the slow map+clear-cofactor runs once per (msg, dst).
# Bounded FIFO like the result memo below.
_H2G_MAX = 256
_h2g: Dict[Tuple[bytes, bytes], tuple] = {}


def hash_to_g2_cached(msg: bytes, dst: bytes):
    key = (bytes(msg), dst)
    pt = _h2g.get(key)
    if pt is None:
        ct = _ctier()
        if ct is not None:
            # C hash-to-curve (bit-identical to the pure map, pinned by
            # the differential suite): a C miss instead of the pure map
            pt = ct.g2_point(ct.hash_to_g2_blob(key[0], dst))
        else:
            pt = hash_to_curve.hash_to_g2(msg, dst)
        bounded_put(_h2g, key, pt, _H2G_MAX)
    return pt


def _hash_blob(ct, msg: bytes, dst: bytes):
    """Affine blob of hash_to_g2(msg, dst) for the C tier, memoized like
    the point cache above.  Since the hash-to-curve satellite the whole
    map runs in C (expand_message_xmd → SVDW → clear cofactor), so a cold
    miss runs in C instead of the pure map."""
    key = (bytes(msg), dst)
    b = _h2g_blob.get(key)
    if b is None:
        b = ct.hash_to_g2_blob(key[0], dst)
        bounded_put(_h2g_blob, key, b, _H2G_MAX)
    return b


_h2g_blob: Dict[Tuple[bytes, bytes], object] = {}


def _finite(ct, pairs):
    """Drop identity operands before a C pairing call — they contribute
    the neutral 1, exactly like the pure product's skip."""
    return [pr for pr in pairs if pr[0] is not ct.INF and pr[1] is not ct.INF]


def _c_verify_eq(ct, lhs, msg: bytes, dst: bytes, sgb) -> bool:
    """The C-tier verification equation e(lhs, H(msg))·e(-g1, σ) == 1 for
    a finite lhs blob and a decompressed signature blob (σ == identity
    contributes the neutral 1, like the pure product's skip) — the one
    shape verify/fast_aggregate_verify/batch re-checks all share."""
    pairs = [(lhs, _hash_blob(ct, msg, dst))]
    if sgb is not ct.INF:
        pairs.append((_neg_g1_gen_blob(ct), sgb))
    return ct.pairing_check(_finite(ct, pairs))


def sign(sk: int, msg: bytes, dst: bytes = DST_SIG) -> bytes:
    ct = _ctier()
    if ct is not None:
        out = ct.g2_mul(_hash_blob(ct, msg, dst), sk)
        return curve.g2_compress(ct.g2_point(out))
    return curve.g2_compress(curve.g2_mul(hash_to_g2_cached(msg, dst), sk))


def _neg_g1_gen():
    return curve.g1_neg(curve.G1_GEN)


def verify(pk: bytes, msg: bytes, sig: bytes, dst: bytes = DST_SIG, pk_point=None) -> bool:
    """e(pk, H(m)) · e(-g1, sig) == 1.  `pk_point` lets callers holding a
    cached decompressed (subgroup-checked) pubkey skip the G1 decompress
    (the C tier keeps its own bounded decompress memo instead)."""
    ct = _ctier()
    if ct is not None:
        pkb = ct.g1_blob(pk_point) if pk_point is not None else ct.g1_decompress_cached(pk)
        if pkb is None or pkb is ct.INF:
            return False
        sgb = ct.g2_decompress(sig)
        if sgb is None:
            return False
        return _c_verify_eq(ct, pkb, msg, dst, sgb)
    pkp = pk_point if pk_point is not None else curve.g1_decompress(pk)
    sigp = curve.g2_decompress(sig)
    if pkp is None or sigp is None or curve.g1_is_inf(pkp):
        return False
    h = hash_to_g2_cached(msg, dst)
    return pairing_check_cached(
        [(pkp, h), (_neg_g1_gen(), sigp)]
    )


def pairing_check_cached(pairs) -> bool:
    from . import pairing

    return pairing.pairing_check(pairs)


# -- aggregation ------------------------------------------------------------


def aggregate_signatures(sigs: Sequence[bytes]) -> Optional[bytes]:
    """Σ sigᵢ in G2; None if any blob is invalid."""
    ct = _ctier()
    if ct is not None:
        blobs = []
        for s in sigs:
            b = ct.g2_decompress(s)
            if b is None:
                return None
            if b is not ct.INF:
                blobs.append(b)
        if not sigs:
            return None
        return curve.g2_compress(ct.g2_point(ct.g2_sum(blobs)))
    pts = []
    for s in sigs:
        p = curve.g2_decompress(s)
        if p is None:
            return None
        pts.append(p)
    if not pts:
        return None
    return curve.g2_compress(_sum_g2(pts))


def aggregate_pubkeys(pks: Sequence[bytes]) -> Optional[bytes]:
    """Σ pkᵢ in G1 (the apk of FastAggregateVerify)."""
    ct = _ctier()
    if ct is not None:
        blobs = _apk_blobs(ct, pks)
        if blobs is None or not blobs:
            return None
        return curve.g1_compress(ct.g1_point(ct.g1_sum(blobs)))
    pts = []
    for pk in pks:
        p = curve.g1_decompress(pk)
        if p is None or curve.g1_is_inf(p):
            return None
        pts.append(p)
    if not pts:
        return None
    return curve.g1_compress(_sum_g1(pts))


def _apk_blobs(ct, pks: Sequence[bytes]) -> Optional[list]:
    """Decompress a pubkey list to blobs (memoized); None on any invalid
    or infinity key — the same reject set as the pure fold."""
    blobs = []
    for pk in pks:
        b = ct.g1_decompress_cached(pk)
        if b is None or b is ct.INF:
            return None
        blobs.append(b)
    return blobs


def _sum_g1(pts):
    # only reached from the pure lanes (the C lanes fold blobs via
    # ctier.g1_sum/g2_sum directly, never through here)
    if _fold_device is not None and len(pts) >= cuda_tier.MIN_BATCH:
        return cuda_tier.aggregate_g1(pts, mesh=_fold_mesh, device=_fold_device)
    acc = curve.G1_INF
    for p in pts:
        acc = curve.g1_add(acc, p)
    return acc


def _sum_g2(pts):
    if _fold_device is not None and len(pts) >= cuda_tier.MIN_BATCH:
        return cuda_tier.aggregate_g2(pts, mesh=_fold_mesh, device=_fold_device)
    acc = curve.G2_INF
    for p in pts:
        acc = curve.g2_add(acc, p)
    return acc


_fold_device = None  # the batched fold's device; None: the fold is off
_fold_mesh = None  # the verify engine's mesh the fold shards over; None: unsharded


def set_jax_aggregation(enabled: bool, mesh=None, device=None) -> None:
    """Route the pure lanes' multi-point G1/G2 sums (from MIN_BATCH points
    on) through the batched fold of `cuda_tier`: sharded over `mesh` (the
    verify engine's, whose first device a named `device` must be; a mesh
    that cannot shard the bucket evenly folds unsharded on that device),
    else on `device`, the card unless the caller names the CPU, raising
    where there is no card.
    Engine nodes turn it on at start with `[tpu] bls_jax_aggregation`
    (the reference's name); the C lanes never reach it."""
    global _fold_device, _fold_mesh
    if not enabled:
        _fold_device = _fold_mesh = None
        return
    _fold_device = mesh.lead(device) if mesh is not None else cuda_tier.resolve_device(device)
    _fold_mesh = mesh


def fast_aggregate_verify(
    pks: Sequence[bytes], msg: bytes, agg_sig: bytes, dst: bytes = DST_SIG
) -> bool:
    """All signers signed the SAME msg (PoP-gated).  One pairing check:
    e(Σpk, H(m)) · e(-g1, σ) == 1."""
    if not pks:
        return False
    ct = _ctier()
    if ct is not None:
        blobs = _apk_blobs(ct, pks)
        if blobs is None:
            return False
        apk = ct.g1_sum(blobs)
        if apk is ct.INF:
            return False  # keys summing to 0 mod r: same reject as verify()
        sgb = ct.g2_decompress(agg_sig)
        if sgb is None:
            return False
        return _c_verify_eq(ct, apk, msg, dst, sgb)
    apk = aggregate_pubkeys(pks)
    if apk is None:
        return False
    return verify(apk, msg, agg_sig, dst)


def aggregate_verify(
    pks: Sequence[bytes], msgs: Sequence[bytes], agg_sig: bytes, dst: bytes = DST_SIG
) -> bool:
    """Distinct messages: Π e(pkᵢ, H(mᵢ)) · e(-g1, σ) == 1.  Messages must
    be distinct per the PoP-less soundness requirement."""
    if not pks or len(pks) != len(msgs) or len(set(msgs)) != len(msgs):
        return False
    ct = _ctier()
    if ct is not None:
        sgb = ct.g2_decompress(agg_sig)
        if sgb is None:
            return False
        pairs = []
        for pk, m in zip(pks, msgs):
            pkb = ct.g1_decompress_cached(pk)
            if pkb is None or pkb is ct.INF:
                return False
            pairs.append((pkb, _hash_blob(ct, m, dst)))
        if sgb is not ct.INF:
            pairs.append((_neg_g1_gen_blob(ct), sgb))
        return ct.pairing_check(_finite(ct, pairs))
    sigp = curve.g2_decompress(agg_sig)
    if sigp is None:
        return False
    pairs = []
    for pk, m in zip(pks, msgs):
        pkp = curve.g1_decompress(pk)
        if pkp is None or curve.g1_is_inf(pkp):
            return False
        pairs.append((pkp, hash_to_g2_cached(m, dst)))
    pairs.append((_neg_g1_gen(), sigp))
    return pairing_check_cached(pairs)


# -- proof of possession ----------------------------------------------------


def pop_prove(sk: int) -> bytes:
    return sign(sk, sk_to_pk(sk), DST_POP)


def pop_verify(pk: bytes, proof: bytes) -> bool:
    return verify(pk, pk, proof, DST_POP)


def batch_pop_verify(items: Sequence[Tuple[bytes, bytes]]) -> bool:
    """All-or-nothing PoP check for a whole validator set in ONE blinded
    pairing product (per-key fallback is the caller's job on False)."""
    if not items:
        return True
    ct = _ctier()
    if ct is not None:
        pairs = []
        for pk, proof in items:
            pkb = ct.g1_decompress_cached(pk)
            prf = ct.g2_decompress(proof)
            if pkb is None or prf is None or pkb is ct.INF:
                return False
            rnd = int.from_bytes(os.urandom(8), "big") | 1
            pairs.append((ct.g1_mul(pkb, rnd), _hash_blob(ct, pk, DST_POP)))
            if prf is not ct.INF:
                pairs.append((ct.g1_mul(_neg_g1_gen_blob(ct), rnd), prf))
        return ct.pairing_check(_finite(ct, pairs))
    pairs = []
    for pk, proof in items:
        pkp = curve.g1_decompress(pk)
        prf = curve.g2_decompress(proof)
        if pkp is None or prf is None or curve.g1_is_inf(pkp):
            return False
        rnd = int.from_bytes(os.urandom(8), "big") | 1
        h = hash_to_g2_cached(pk, DST_POP)
        pairs.append((curve.g1_mul(pkp, rnd), h))
        pairs.append((curve.g1_mul(_neg_g1_gen(), rnd), prf))
    return pairing_check_cached(pairs)


# -- batched aggregate checks (the fastsync/statesync fan-in) ---------------

# result memo: (tier, sha256(pk bytes concat), msg, sig) -> bool.  Bounded
# FIFO; async pre-verify lanes insert, the sync verify_commit path hits.
# Keyed by the tier that produced the verdict: the tiers are verdict-
# identical by construction, but telemetry attributes each check to the
# tier that RAN it — a verdict cached by the pure tier must not be
# re-attributed to the C tier after a restart/tier flip (and a forced-pure
# differential run must never be served C-tier entries).
_MEMO_MAX = 4096
_memo: Dict[Tuple[str, bytes, bytes, bytes], bool] = {}


def _memo_key(pks: Sequence[bytes], msg: bytes, sig: bytes):
    h = hashlib.sha256()
    for pk in pks:
        h.update(pk)
    return (active_tier(), h.digest(), msg, sig)


def memo_put(pks: Sequence[bytes], msg: bytes, sig: bytes, ok: bool) -> None:
    bounded_put(_memo, _memo_key(pks, msg, sig), ok, _MEMO_MAX)


def memo_get(pks: Sequence[bytes], msg: bytes, sig: bytes) -> Optional[bool]:
    return _memo.get(_memo_key(pks, msg, sig))


def batch_verify_aggregates(
    items: Sequence[Tuple[Sequence[bytes], bytes, bytes]], dst: bytes = DST_SIG
) -> List[bool]:
    """items: (pubkeys, msg, agg_sig) triples, each a FastAggregateVerify
    claim.  One blinded pairing product for the whole batch; on failure,
    per-item re-checks attribute the liar.  Results are memoized."""
    out: List[Optional[bool]] = [None] * len(items)
    todo = []
    for i, (pks, msg, sig) in enumerate(items):
        hit = memo_get(pks, msg, sig)
        if hit is not None:
            out[i] = hit
            continue
        todo.append(i)
    ct = _ctier()
    if todo and ct is not None:
        _batch_verify_aggregates_c(ct, items, todo, out, dst)
    elif todo:
        pairs = []
        decoded = {}
        for i in todo:
            pks, msg, sig = items[i]
            apk = aggregate_pubkeys(pks)
            apkp = curve.g1_decompress(apk) if apk is not None else None
            sigp = curve.g2_decompress(sig) if apk is not None else None
            # reject the infinity aggregate pubkey exactly like verify()
            # does: e(INF, H(m)) == 1 for ANY message, and this lane's
            # memo feeds the strict synchronous path — the two lanes must
            # agree on every input
            if apkp is None or sigp is None or curve.g1_is_inf(apkp):
                out[i] = False
                memo_put(pks, msg, sig, False)
                continue
            decoded[i] = (apkp, sigp, msg)
        live = list(decoded)
        if len(live) == 1:
            i = live[0]
            apkp, sigp, msg = decoded[i]
            ok = pairing_check_cached(
                [(apkp, hash_to_g2_cached(msg, dst)), (_neg_g1_gen(), sigp)]
            )
            out[i] = ok
            memo_put(*items[i], ok)
        elif live:
            for i in live:
                apkp, sigp, msg = decoded[i]
                rnd = int.from_bytes(os.urandom(8), "big") | 1
                pairs.append(
                    (curve.g1_mul(apkp, rnd), hash_to_g2_cached(msg, dst))
                )
                pairs.append((curve.g1_mul(_neg_g1_gen(), rnd), sigp))
            if pairing_check_cached(pairs):
                for i in live:
                    out[i] = True
                    memo_put(*items[i], True)
            else:
                for i in live:
                    apkp, sigp, msg = decoded[i]
                    ok = pairing_check_cached(
                        [
                            (apkp, hash_to_g2_cached(msg, dst)),
                            (_neg_g1_gen(), sigp),
                        ]
                    )
                    out[i] = ok
                    memo_put(*items[i], ok)
    return [bool(v) for v in out]


def _batch_verify_aggregates_c(ct, items, todo, out, dst) -> None:
    """The C-tier lane of batch_verify_aggregates: same blinded-product /
    per-item-attribution structure, blobs end to end.  Reject set matches
    the pure lane exactly (invalid/infinity aggregate pubkey, bad sig
    encodings), which the differential suite pins."""
    decoded = {}
    for i in todo:
        pks, msg, sig = items[i]
        blobs = _apk_blobs(ct, pks) if pks else None
        apkb = ct.g1_sum(blobs) if blobs else None
        sgb = ct.g2_decompress(sig) if apkb is not None else None
        if apkb is None or apkb is ct.INF or sgb is None:
            out[i] = False
            memo_put(pks, msg, sig, False)
            continue
        decoded[i] = (apkb, sgb, msg)
    live = list(decoded)
    if len(live) == 1:
        i = live[0]
        apkb, sgb, msg = decoded[i]
        ok = _c_verify_eq(ct, apkb, msg, dst, sgb)
        out[i] = ok
        memo_put(*items[i], ok)
    elif live:
        pairs = []
        for i in live:
            apkb, sgb, msg = decoded[i]
            rnd = int.from_bytes(os.urandom(8), "big") | 1
            pairs.append((ct.g1_mul(apkb, rnd), _hash_blob(ct, msg, dst)))
            if sgb is not ct.INF:
                pairs.append((ct.g1_mul(_neg_g1_gen_blob(ct), rnd), sgb))
        if ct.pairing_check(_finite(ct, pairs)):
            for i in live:
                out[i] = True
                memo_put(*items[i], True)
        else:
            for i in live:
                apkb, sgb, msg = decoded[i]
                ok = _c_verify_eq(ct, apkb, msg, dst, sgb)
                out[i] = ok
                memo_put(*items[i], ok)
