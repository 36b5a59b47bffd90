"""Validator and ValidatorSet: batched commit verification.

The port's subset of tendermint_tpu/types/validator.py.  Reference parity:
types/validator.go (Validator:16), types/validator_set.go
(ValidatorSet:42, VerifyCommit:629, VerifyFutureCommit:703,
VerifyCommitTrusting:754).

VerifyCommit* gather (pubkey, msg, sig) triples for ALL non-absent
signatures and hand them to the installed batch hooks (crypto/batch.py) as
one batch, then tally voting power from the boolean mask.  The reference's
early exit at 2/3 becomes whole-batch verification — strictly stricter (a
bad signature after the 2/3 mark fails the commit) and deterministic.

Proposer rotation and validator-set change sets are not part of this
slice: a set is built once from its validators, sorted by address.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..crypto import batch as crypto_batch
from ..crypto.keys import Ed25519PubKey
from .block import BlockID, Commit

INT64_MAX = (1 << 63) - 1

# types/validator_set.go:25
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8


def mixed_batch_verify(
    pubkey_objs: Sequence[Ed25519PubKey],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    batch_verify: Optional[Callable] = None,
    indexed: Optional[tuple] = None,
) -> List[bool]:
    """Verify a commit's signatures through the installed batch hooks.

    `indexed=(set_key, set_pubkey_rows, row_idxs)` lets callers that know
    the validator-set identity and row indices route through the
    per-valset device table engine (crypto/batch.py indexed hook); when it
    declines, the flat batch verifier serves.  This slice carries ed25519
    keys only and raises on any other key type."""
    for pk in pubkey_objs:
        if not isinstance(pk, Ed25519PubKey):
            raise TypeError(f"unsupported key type {type(pk).__name__}: this slice verifies ed25519 only")
    if not msgs:
        return []
    if indexed is not None and batch_verify is None:
        iv = crypto_batch.get_indexed_verifier()
        if iv is not None:
            set_key, set_rows, row_idxs = indexed
            res = iv(set_key, set_rows, row_idxs, msgs, sigs)
            if res is not None:
                return [bool(r) for r in res]
    verify = batch_verify or crypto_batch.get_verifier()
    return [bool(r) for r in verify([pk.bytes() for pk in pubkey_objs], msgs, sigs)]


class NotEnoughVotingPowerError(Exception):
    """types/validator_set.go:838 ErrNotEnoughVotingPowerSigned."""

    def __init__(self, got: int, needed: int):
        self.got = got
        self.needed = needed
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}"
        )


@dataclass
class Validator:
    """types/validator.go:16."""

    address: bytes
    pub_key: Ed25519PubKey
    voting_power: int

    @classmethod
    def new(cls, pub_key: Ed25519PubKey, voting_power: int) -> "Validator":
        return cls(pub_key.address(), pub_key, voting_power)

    def copy(self) -> "Validator":
        return Validator(self.address, self.pub_key, self.voting_power)


class ValidatorSet:
    """Validators sorted by address (types/validator_set.go:42), with the
    same construction checks as the JAX package's set."""

    def __init__(self, validators: List[Validator]):
        vals = sorted((v.copy() for v in validators), key=lambda v: v.address)
        if not vals:
            raise ValueError("applying the validator changes would result in empty set")
        total = 0
        prev = None
        for v in vals:
            if v.address == prev:
                raise ValueError(f"duplicate entry {v} in changes")
            if v.voting_power < 0:
                raise ValueError(f"voting power can't be negative: {v.voting_power}")
            if v.voting_power > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    f"voting power can't be higher than {MAX_TOTAL_VOTING_POWER}: {v.voting_power}"
                )
            if v.voting_power == 0:
                raise ValueError(f"cannot process validators with voting power 0: {[v]}")
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power must not exceed {MAX_TOTAL_VOTING_POWER}; got {total}"
                )
            prev = v.address
        self.validators: List[Validator] = vals
        self._total_voting_power = total
        self._pk_digest: Optional[bytes] = None

    def pubkeys_digest(self) -> bytes:
        """Stable key for this set's pubkey rows (device table cache key):
        sha256 over the length-prefixed raw pubkeys, set order."""
        if self._pk_digest is None:
            h = hashlib.sha256()
            for v in self.validators:
                pk = v.pub_key.bytes()
                h.update(bytes([len(pk) & 0xFF]))
                h.update(pk)
            self._pk_digest = h.digest()
        return self._pk_digest

    def size(self) -> int:
        return len(self.validators)

    def __len__(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        return self._total_voting_power

    def _index_of(self, address: bytes) -> Optional[int]:
        lo, hi = 0, len(self.validators)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.validators[mid].address < address:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(self.validators) and self.validators[lo].address == address:
            return lo
        return None

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        idx = self._index_of(address)
        if idx is None:
            return -1, None
        return idx, self.validators[idx].copy()

    def _indexed(self, row_idxs: List[int]):
        """The indexed-hook argument, or None when no table engine is
        installed.  Rows are passed lazily: a table-cache hit never builds
        the V-sized list."""
        if crypto_batch.get_indexed_verifier() is None:
            return None
        return (
            self.pubkeys_digest(),
            lambda: [v.pub_key.bytes() for v in self.validators],
            row_idxs,
        )

    def verify_commit(
        self,
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit: Commit,
        batch_verify: Optional[Callable] = None,
    ) -> None:
        """+2/3 of this set signed the commit (types/validator_set.go:629).
        Signatures and validators are index-aligned, so pubkeys gather by
        index — the validator index IS the table row."""
        if self.size() != len(commit.signatures):
            raise ValueError(
                f"invalid commit -- wrong set size: {self.size()} vs {len(commit.signatures)}"
            )
        _verify_commit_basic(commit, height, block_id)

        idxs, pubkeys, msgs, sigs = [], [], [], []
        for idx, cs in enumerate(commit.signatures):
            if cs.is_absent():
                continue
            idxs.append(idx)
            pk = self.validators[idx].pub_key
            pubkeys.append(pk)
            msgs.append(commit.vote_sign_bytes(chain_id, idx, pub_key=pk))
            sigs.append(cs.signature)

        ok = mixed_batch_verify(pubkeys, msgs, sigs, batch_verify, indexed=self._indexed(idxs))

        tallied = 0
        needed = self.total_voting_power() * 2 // 3
        for pos, idx in enumerate(idxs):
            if not ok[pos]:
                raise ValueError(f"wrong signature (#{idx}): {sigs[pos].hex()}")
            cs = commit.signatures[idx]
            # votes for nil are valid but don't count toward the block
            if block_id == cs.block_id(commit.block_id):
                tallied += self.validators[idx].voting_power
        if tallied <= needed:
            raise NotEnoughVotingPowerError(got=tallied, needed=needed)

    def verify_future_commit(
        self,
        new_set: "ValidatorSet",
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit: Commit,
        batch_verify: Optional[Callable] = None,
    ) -> None:
        """Old-set check for light clients (types/validator_set.go:703):
        commit must be valid for new_set AND >2/3 of the old set signed."""
        new_set.verify_commit(chain_id, block_id, height, commit, batch_verify)

        seen = set()
        idxs, powers, pubkeys, msgs, sigs = [], [], [], [], []
        for idx, cs in enumerate(commit.signatures):
            if cs.is_absent():
                continue
            old_idx, val = self.get_by_address(cs.validator_address)
            if val is None or old_idx in seen:
                continue
            seen.add(old_idx)
            idxs.append(idx)
            powers.append(val.voting_power)
            pubkeys.append(val.pub_key)
            msgs.append(commit.vote_sign_bytes(chain_id, idx, pub_key=val.pub_key))
            sigs.append(cs.signature)

        ok = mixed_batch_verify(pubkeys, msgs, sigs, batch_verify)
        old_voting_power = 0
        for pos, idx in enumerate(idxs):
            if not ok[pos]:
                raise ValueError(f"wrong signature (#{idx}): {sigs[pos].hex()}")
            if block_id == commit.signatures[idx].block_id(commit.block_id):
                old_voting_power += powers[pos]

        needed = self.total_voting_power() * 2 // 3
        if old_voting_power <= needed:
            raise NotEnoughVotingPowerError(got=old_voting_power, needed=needed)

    def verify_commit_trusting(
        self,
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit: Commit,
        trust_numerator: int = 1,
        trust_denominator: int = 3,
        batch_verify: Optional[Callable] = None,
    ) -> None:
        """trustLevel of this (old, trusted) set signed the commit — the
        light-client skipping-verification core (types/validator_set.go:754).
        Validators are matched by address since the commit may belong to a
        different validator set."""
        if trust_numerator * 3 < trust_denominator or trust_numerator > trust_denominator:
            raise ValueError(
                f"trustLevel must be within [1/3, 1], given {trust_numerator}/{trust_denominator}"
            )
        _verify_commit_basic(commit, height, block_id)

        seen_vals = {}
        idxs, row_idxs, powers, pubkeys, msgs, sigs = [], [], [], [], [], []
        for idx, cs in enumerate(commit.signatures):
            if cs.is_absent():
                continue
            val_idx, val = self.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise ValueError(f"double vote from {val} ({seen_vals[val_idx]} and {idx})")
            seen_vals[val_idx] = idx
            idxs.append(idx)
            row_idxs.append(val_idx)
            powers.append(val.voting_power)
            pubkeys.append(val.pub_key)
            msgs.append(commit.vote_sign_bytes(chain_id, idx, pub_key=val.pub_key))
            sigs.append(cs.signature)

        ok = mixed_batch_verify(pubkeys, msgs, sigs, batch_verify, indexed=self._indexed(row_idxs))

        tallied = 0
        needed = self.total_voting_power() * trust_numerator // trust_denominator
        for pos, idx in enumerate(idxs):
            if not ok[pos]:
                raise ValueError(f"wrong signature (#{idx}): {sigs[pos].hex()}")
            if block_id == commit.signatures[idx].block_id(commit.block_id):
                tallied += powers[pos]
        if tallied <= needed:
            raise NotEnoughVotingPowerError(got=tallied, needed=needed)

    def __repr__(self) -> str:
        return f"ValidatorSet(n={len(self.validators)} tvp={self.total_voting_power()})"


def _verify_commit_basic(commit: Commit, height: int, block_id: BlockID) -> None:
    """types/validator_set.go:813."""
    commit.validate_basic()
    if height != commit.height:
        raise ValueError(f"invalid commit height: want {height}, got {commit.height}")
    if block_id != commit.block_id:
        raise ValueError(
            f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
        )
