"""Pluggable batch-verification hook.

The batch design inversion (SURVEY.md §7, BASELINE north star): every hot
caller of per-signature verification in the reference — VerifyCommit
(types/validator_set.go:641-668), VoteSet.AddVote (types/vote_set.go:201),
lite2 VerifyCommitTrusting (types/validator_set.go:754), fast-sync replay —
is re-expressed as "verify this whole batch of (pubkey, msg, sig) at once".

This module owns the indirection: `get_verifier()` returns a callable
``verify(pubkeys, msgs, sigs) -> list[bool]``.  The default is a host-CPU
path; the GPU engine (crypto/batch_verifier.py) installs itself via
`set_verifier`.  Semantics are identical either way: one boolean per
triple, no early exit (whole-batch check is the accelerator win).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

BatchVerifyFn = Callable[[Sequence[bytes], Sequence[bytes], Sequence[bytes]], List[bool]]

_verifier: Optional[BatchVerifyFn] = None


def host_batch_verify(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
) -> List[bool]:
    """Serial host fallback — the compatibility baseline the GPU engine is
    benchmarked against.  Whole-batch C call when the extension is built
    (one ctypes round trip instead of n), else per-key host verify."""
    if len(sigs) > 1:
        from . import hostprep

        res = hostprep.host_verify_batch(pubkeys, msgs, sigs)
        if res is not None:
            return res
    from .keys import Ed25519PubKey

    out = []
    for pk, msg, sig in zip(pubkeys, msgs, sigs):
        try:
            out.append(Ed25519PubKey(pk).verify(msg, sig))
        except ValueError:
            out.append(False)
    return out


def get_verifier() -> BatchVerifyFn:
    return _verifier if _verifier is not None else host_batch_verify


def set_verifier(fn: Optional[BatchVerifyFn]) -> None:
    global _verifier
    _verifier = fn


# Indexed commit verification: callers that know (validator-set key, row
# indices) — verify_commit and friends — can route through a per-valset
# device table (HBM pubkey rows / precomputed window tables) instead of
# shipping pubkeys every call.  fn(set_key, pubkeys, idxs, msgs, sigs)
# returns list[bool], or None to decline (engine cold / set too large),
# in which case the caller falls back to the flat batch verifier.
IndexedVerifyFn = Callable[
    [bytes, Sequence[bytes], Sequence[int], Sequence[bytes], Sequence[bytes]],
    Optional[List[bool]],
]

_indexed_verifier: Optional[IndexedVerifyFn] = None


def get_indexed_verifier() -> Optional[IndexedVerifyFn]:
    return _indexed_verifier


def set_indexed_verifier(fn: Optional[IndexedVerifyFn]) -> None:
    global _indexed_verifier
    _indexed_verifier = fn
