"""Stateless light-client verification core: the port's copy of
tendermint_tpu/lite2/verifier.py.

Reference parity: lite2/verifier.go — VerifyNonAdjacent:32 (trusted-set
VerifyCommitTrusting at trust level + untrusted-set VerifyCommit),
VerifyAdjacent:96 (NextValidatorsHash chain link), Verify:140 dispatcher,
verifyNewHeaderAndVals:159, HeaderExpired:214.

Both commit checks are whole-batch signature verifications: through the
installed hooks each is one kernel launch on the card (the tabulated sum
or the ladder, crypto/batch_verifier.py), not a per-signature loop.
"""

from __future__ import annotations

from typing import Optional

from ..types.block import SignedHeader
from ..types.validator import NotEnoughVotingPowerError, ValidatorSet

DEFAULT_TRUST_LEVEL = (1, 3)  # lite2/trust_options.go DefaultTrustLevel


class InvalidHeaderError(Exception):
    pass


class ErrNewValSetCantBeTrusted(Exception):
    """Not enough trusted-set power signed the new header — the caller
    should bisect, not abort (lite2/errors.go ErrNewValSetCantBeTrusted)."""

    def __init__(self, cause: NotEnoughVotingPowerError):
        self.cause = cause
        super().__init__(str(cause))


def header_expired(sh: SignedHeader, trusting_period_ns: int, now_ns: int) -> bool:
    """lite2/verifier.go:214 — outside the trusting period?"""
    expiration = sh.time_ns + trusting_period_ns
    return now_ns >= expiration


def _verify_new_header_and_vals(
    chain_id: str,
    untrusted_sh: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted_sh: SignedHeader,
    now_ns: int,
    max_clock_drift_ns: int,
) -> None:
    """lite2/verifier.go:159."""
    untrusted_sh.validate_basic(chain_id)
    if untrusted_sh.height <= trusted_sh.height:
        raise InvalidHeaderError(
            f"expected new header height {untrusted_sh.height} to be greater than one of "
            f"old header {trusted_sh.height}"
        )
    if untrusted_sh.time_ns <= trusted_sh.time_ns:
        raise InvalidHeaderError(
            f"expected new header time {untrusted_sh.time_ns} to be after old header time "
            f"{trusted_sh.time_ns}"
        )
    if untrusted_sh.time_ns >= now_ns + max_clock_drift_ns:
        raise InvalidHeaderError(
            f"new header has a time from the future {untrusted_sh.time_ns} "
            f"(now: {now_ns}, max_clock_drift: {max_clock_drift_ns})"
        )
    if untrusted_sh.header.validators_hash != untrusted_vals.hash():
        raise InvalidHeaderError(
            f"expected new header validators {untrusted_sh.header.validators_hash.hex()} to "
            f"match those supplied ({untrusted_vals.hash().hex()})"
        )


def verify_non_adjacent(
    chain_id: str,
    trusted_sh: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted_sh: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
    trust_level: tuple = DEFAULT_TRUST_LEVEL,
    batch_verify=None,
) -> None:
    """lite2/verifier.go:32 — skipping verification: `trust_level` of the
    validator set we trusted at height T signed the new header at H > T+1,
    AND +2/3 of the new header's own set signed it."""
    if untrusted_sh.height == trusted_sh.height + 1:
        raise ValueError("verify_non_adjacent requires non-adjacent headers; use verify_adjacent")
    if header_expired(trusted_sh, trusting_period_ns, now_ns):
        raise InvalidHeaderError("trusted header expired")
    _verify_new_header_and_vals(
        chain_id, untrusted_sh, untrusted_vals, trusted_sh, now_ns, max_clock_drift_ns
    )
    try:
        trusted_next_vals.verify_commit_trusting(
            chain_id,
            untrusted_sh.commit.block_id,
            untrusted_sh.height,
            untrusted_sh.commit,
            trust_numerator=trust_level[0],
            trust_denominator=trust_level[1],
            batch_verify=batch_verify,
            # aggregate (BLS) commits: the signer bitmap indexes the
            # untrusted header's own set; power is tallied against the
            # trusted set by address
            commit_vals=untrusted_vals,
        )
    except NotEnoughVotingPowerError as e:
        raise ErrNewValSetCantBeTrusted(e)
    untrusted_vals.verify_commit(
        chain_id,
        untrusted_sh.commit.block_id,
        untrusted_sh.height,
        untrusted_sh.commit,
        batch_verify=batch_verify,
    )


def verify_adjacent(
    chain_id: str,
    trusted_sh: SignedHeader,
    untrusted_sh: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
    batch_verify=None,
) -> None:
    """lite2/verifier.go:96 — sequential verification: H == T+1, so the new
    validator hash must equal the trusted header's NextValidatorsHash."""
    if untrusted_sh.height != trusted_sh.height + 1:
        raise ValueError("headers must be adjacent in height")
    if header_expired(trusted_sh, trusting_period_ns, now_ns):
        raise InvalidHeaderError("trusted header expired")
    _verify_new_header_and_vals(
        chain_id, untrusted_sh, untrusted_vals, trusted_sh, now_ns, max_clock_drift_ns
    )
    if untrusted_sh.header.validators_hash != trusted_sh.header.next_validators_hash:
        raise InvalidHeaderError(
            f"expected old header next validators ({trusted_sh.header.next_validators_hash.hex()}) "
            f"to match those from new header ({untrusted_sh.header.validators_hash.hex()})"
        )
    untrusted_vals.verify_commit(
        chain_id,
        untrusted_sh.commit.block_id,
        untrusted_sh.height,
        untrusted_sh.commit,
        batch_verify=batch_verify,
    )


def verify(
    chain_id: str,
    trusted_sh: SignedHeader,
    trusted_next_vals: Optional[ValidatorSet],
    untrusted_sh: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int,
    trust_level: tuple = DEFAULT_TRUST_LEVEL,
) -> None:
    """lite2/verifier.go:140 — dispatch on adjacency."""
    if untrusted_sh.height == trusted_sh.height + 1:
        verify_adjacent(
            chain_id, trusted_sh, untrusted_sh, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns,
        )
    else:
        verify_non_adjacent(
            chain_id, trusted_sh, trusted_next_vals, untrusted_sh, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns, trust_level,
        )
