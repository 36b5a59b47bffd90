"""Canonical sign-bytes for votes.

Reference parity: types/canonical.go (CanonicalVote),
types/vote.go:83 (SignBytes).  Proposal and timestamp-free (BLS) sign-bytes
are not part of this slice.

Batch-first layout choice: height/round/pol_round are fixed64 (as in the
reference) and the embedded BlockID/timestamp have fixed shapes, so all vote
sign-bytes for a given (chain_id, commit) differ only in the timestamp field
— messages in one verification batch share a single static length, which is
exactly what a batched SHA-512 pass wants.
"""

from __future__ import annotations

from ..encoding.proto import (
    field_bytes,
    field_fixed64,
    field_varint,
    length_prefixed,
)

# SignedMsgType byte values (reference types/signed_msg_type.go)
PREVOTE_TYPE = 0x01
PRECOMMIT_TYPE = 0x02


def _canonical_part_set_header(total: int, hash_: bytes) -> bytes:
    return field_bytes(1, hash_) + field_varint(2, total)


def _canonical_block_id(hash_: bytes, psh_total: int, psh_hash: bytes) -> bytes:
    inner = field_bytes(1, hash_)
    psh = _canonical_part_set_header(psh_total, psh_hash)
    if psh:
        inner += field_bytes(2, psh, emit_zero=False)
    return inner


def canonical_vote_sign_bytes(
    chain_id: str,
    vote_type: int,
    height: int,
    round_: int,
    block_id_hash: bytes,
    block_id_psh_total: int,
    block_id_psh_hash: bytes,
    timestamp_ns: int,
) -> bytes:
    """Deterministic byte layout signed by validators for a vote.

    Mirrors CanonicalizeVote (types/canonical.go:73): type, fixed64 height,
    fixed64 round, BlockID, timestamp, chain_id — length-prefixed like
    amino's MarshalBinaryLengthPrefixed (types/vote.go:84).
    """
    payload = field_varint(1, vote_type)
    payload += field_fixed64(2, height)
    payload += field_fixed64(3, round_)
    bid = _canonical_block_id(block_id_hash, block_id_psh_total, block_id_psh_hash)
    if bid:
        payload += field_bytes(4, bid)
    # Timestamp as fixed64 unix-ns (not the varint proto Timestamp): keeps
    # every vote's sign-bytes the same static length so a commit's batch is
    # one fixed-shape [N, L] array.
    payload += field_fixed64(5, timestamp_ns, emit_zero=True)
    payload += field_bytes(6, chain_id)
    return length_prefixed(payload)
