"""Validator and ValidatorSet: proposer-priority math, change sets and
batched commit verification.

The port's copy of tendermint_tpu/types/validator.py, for every key type.
A commit of a set with BLS12-381 members is checked per vote; an
aggregate (BLS) commit of a uniformly BLS set is checked by one pairing
(`verify_aggregate_commit`).
Reference parity: types/validator.go (Validator:16), types/validator_set.go
(ValidatorSet:42, IncrementProposerPriority:86, UpdateWithChangeSet:624,
VerifyCommit:629, VerifyFutureCommit:703, VerifyCommitTrusting:754).  The
priority arithmetic is overflow-aware int64 math that must match the
reference bit for bit across nodes — Python ints are unbounded, so
clipping is explicit here.

ValidatorSet.hash is the merkle root over Validator.bytes, which the light
client checks headers against; to_dict / from_dict keep the JAX package's
layout, so a trusted store carries across.

VerifyCommit* gather (pubkey, msg, sig) triples for ALL non-absent
signatures, hand the ed25519 ones to the installed batch hooks
(crypto/batch.py) as one batch and verify the other key types on the host
with their own PubKey.verify, then tally voting power from the boolean
mask.  The reference's early exit at 2/3 becomes whole-batch verification
— strictly stricter (a bad signature after the 2/3 mark fails the commit)
and deterministic.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..crypto import batch as crypto_batch
from ..crypto import merkle
from ..crypto.keys import Ed25519PubKey, PubKey, pubkey_from_dict
from ..encoding import codec
from ..encoding.proto import field_bytes, field_varint
from .agg_commit import AggregateCommit
from .block import BlockID, Commit

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)

# types/validator_set.go:25 — guards clipping/overflow in priority math
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8
# types/validator_set.go:29
PRIORITY_WINDOW_SIZE_FACTOR = 2


def safe_add_clip(a: int, b: int) -> int:
    c = a + b
    return min(max(c, INT64_MIN), INT64_MAX)


def safe_sub_clip(a: int, b: int) -> int:
    c = a - b
    return min(max(c, INT64_MIN), INT64_MAX)


def mixed_batch_verify(
    pubkey_objs: Sequence[PubKey],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    batch_verify: Optional[Callable] = None,
    indexed: Optional[tuple] = None,
) -> List[bool]:
    """Verify a commit's signatures, routing by key type: ed25519 rides the
    installed batch hooks (crypto/batch.py); other key types (sr25519,
    secp256k1, threshold multisig) verify with their own PubKey.verify on
    the host, and an exception there is a False verdict.

    `indexed=(set_key, set_pubkey_rows, row_idxs)` lets callers that know
    the validator-set identity and row indices route through the
    per-valset device table engine (crypto/batch.py indexed hook); it
    serves only when every signer of the call is ed25519, and when it
    declines, the flat batch verifier serves."""
    n = len(msgs)
    out: List[bool] = [False] * n
    ed_idx = [i for i, pk in enumerate(pubkey_objs) if isinstance(pk, Ed25519PubKey)]
    if ed_idx and len(ed_idx) == n and indexed is not None and batch_verify is None:
        iv = crypto_batch.get_indexed_verifier()
        if iv is not None:
            set_key, set_rows, row_idxs = indexed
            res = iv(set_key, set_rows, row_idxs, msgs, sigs)
            if res is not None:
                return [bool(r) for r in res]
    if ed_idx:
        verify = batch_verify or crypto_batch.get_verifier()
        res = verify(
            [pubkey_objs[i].bytes() for i in ed_idx],
            [msgs[i] for i in ed_idx],
            [sigs[i] for i in ed_idx],
        )
        for i, r in zip(ed_idx, res):
            out[i] = bool(r)
    if len(ed_idx) != n:
        ed_set = set(ed_idx)
        for i, pk in enumerate(pubkey_objs):
            if i in ed_set:
                continue
            try:
                out[i] = bool(pk.verify(msgs[i], sigs[i]))
            except Exception:
                out[i] = False
    return out


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
    """types/validator.go:16.  ProposerPriority is volatile per-round state."""

    address: bytes
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def new(cls, pub_key: PubKey, voting_power: int) -> "Validator":
        return cls(pub_key.address(), pub_key, voting_power, 0)

    def copy(self) -> "Validator":
        return Validator(self.address, self.pub_key, self.voting_power, self.proposer_priority)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break toward the lower address
        (types/validator.go:41)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")

    def bytes(self) -> bytes:
        """Hash input: pubkey + power, excluding address and priority
        (types/validator.go:83)."""
        pk = self.pub_key.to_dict()
        inner = field_bytes(1, pk["type"]) + field_bytes(2, pk["value"])
        return field_bytes(1, inner) + field_varint(2, self.voting_power)

    def to_dict(self) -> dict:
        return {
            "address": self.address,
            "pub_key": self.pub_key.to_dict(),
            "voting_power": self.voting_power,
            "proposer_priority": self.proposer_priority,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Validator":
        return cls(
            d["address"], pubkey_from_dict(d["pub_key"]), d["voting_power"], d["proposer_priority"]
        )

    def __repr__(self) -> str:
        return f"Validator{{{self.address.hex()[:12]} VP:{self.voting_power} A:{self.proposer_priority}}}"


class ValidatorSet:
    """Validators sorted by address; proposer rotates by priority
    (types/validator_set.go:42)."""

    def __init__(self, validators: Optional[List[Validator]] = None):
        self.validators: List[Validator] = []
        self.proposer: Optional[Validator] = None
        self._total_voting_power = 0
        self._pk_digest: Optional[bytes] = None
        if validators:
            self._update_with_change_set(validators, allow_deletes=False)
            self.increment_proposer_priority(1)

    def pubkeys_digest(self) -> bytes:
        """Stable key for this set's pubkey rows (device table cache key):
        sha256 over the length-prefixed raw pubkeys, set order, cached until
        the membership changes.  Unlike hash() it ignores voting power and
        priorities, which don't affect the pubkey table."""
        if self._pk_digest is None:
            h = hashlib.sha256()
            for v in self.validators:
                pk = v.pub_key.bytes()
                h.update(bytes([len(pk) & 0xFF]))
                h.update(pk)
            self._pk_digest = h.digest()
        return self._pk_digest

    # -- basic accessors ---------------------------------------------------
    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def size(self) -> int:
        return len(self.validators)

    def __len__(self) -> int:
        return len(self.validators)

    def has_address(self, address: bytes) -> bool:
        return self._index_of(address) is not None

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

    def get_by_index(self, index: int) -> Tuple[Optional[bytes], Optional[Validator]]:
        if index < 0 or index >= len(self.validators):
            return None, None
        v = self.validators[index]
        return v.address, v.copy()

    def total_voting_power(self) -> int:
        if self._total_voting_power == 0:
            self._update_total_voting_power()
        return self._total_voting_power

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total = safe_add_clip(total, v.voting_power)
            if total > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power must not exceed {MAX_TOTAL_VOTING_POWER}; got {total}"
                )
        self._total_voting_power = total

    def copy(self) -> "ValidatorSet":
        new = ValidatorSet()
        new.validators = [v.copy() for v in self.validators]
        new.proposer = self.proposer
        new._total_voting_power = self._total_voting_power
        new._pk_digest = self._pk_digest
        return new

    def hash(self) -> bytes:
        """Merkle root over validator bytes (types/validator_set.go:315)."""
        if not self.validators:
            return b""
        return merkle.hash_from_byte_slices([v.bytes() for v in self.validators])

    # -- proposer rotation -------------------------------------------------
    def get_proposer(self) -> Optional[Validator]:
        if not self.validators:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer.copy()

    def _find_proposer(self) -> Validator:
        proposer = None
        for v in self.validators:
            if proposer is None:
                proposer = v
            elif v.address != proposer.address:
                proposer = proposer.compare_proposer_priority(v)
        return proposer

    def increment_proposer_priority(self, times: int) -> None:
        """types/validator_set.go:86."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("cannot call increment_proposer_priority with non-positive times")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = safe_add_clip(v.proposer_priority, v.voting_power)
        # compare_proposer_priority returns one of its operands, so `mostest`
        # is the live list entry and the decrement below sticks.
        mostest = self._get_val_with_most_priority()
        mostest.proposer_priority = safe_sub_clip(
            mostest.proposer_priority, self.total_voting_power()
        )
        return mostest

    def _get_val_with_most_priority(self) -> Validator:
        res = None
        for v in self.validators:
            res = v if res is None else res.compare_proposer_priority(v)
        return res

    def _compute_avg_proposer_priority(self) -> int:
        n = len(self.validators)
        total = sum(v.proposer_priority for v in self.validators)
        # Go integer division truncates toward zero; Python's // floors
        avg = abs(total) // n
        return avg if total >= 0 else -avg

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = safe_sub_clip(v.proposer_priority, avg)

    def _compute_max_min_priority_diff(self) -> int:
        prios = [v.proposer_priority for v in self.validators]
        return abs(max(prios) - min(prios))

    def rescale_priorities(self, diff_max: int) -> None:
        """types/validator_set.go:112."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if diff_max <= 0:
            return
        diff = self._compute_max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                # Go truncates toward zero
                q = abs(v.proposer_priority) // ratio
                v.proposer_priority = q if v.proposer_priority >= 0 else -q

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        c = self.copy()
        c.increment_proposer_priority(times)
        return c

    # -- updates (ABCI validator-set changes) ------------------------------
    def update_with_change_set(self, changes: List[Validator]) -> None:
        self._update_with_change_set(changes, allow_deletes=True)

    def _update_with_change_set(self, changes: List[Validator], allow_deletes: bool) -> None:
        """types/validator_set.go:561 — validate, split into updates/deletes,
        compute priorities for new validators, merge, rescale, recenter."""
        if not changes:
            return
        updates, deletes = self._process_changes(changes)
        if not allow_deletes and deletes:
            raise ValueError(f"cannot process validators with voting power 0: {deletes}")
        num_new = sum(1 for u in updates if not self.has_address(u.address))
        if num_new == 0 and len(self.validators) == len(deletes):
            raise ValueError("applying the validator changes would result in empty set")
        removed_power = self._verify_removals(deletes)
        tvp_after_updates_before_removals = self._verify_updates(updates, removed_power)
        self._compute_new_priorities(updates, tvp_after_updates_before_removals)
        self._apply_updates(updates)
        self._apply_removals(deletes)
        self._pk_digest = None  # membership changed: table cache key rotates
        self._update_total_voting_power()
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        # The cached proposer may have been removed or replaced by
        # _apply_updates: re-point it at the live entry, or clear it so
        # get_proposer() recomputes from the new priorities.
        if self.proposer is not None:
            _, live = self.get_by_address(self.proposer.address)
            self.proposer = live

    @staticmethod
    def _process_changes(orig_changes: List[Validator]) -> Tuple[List[Validator], List[Validator]]:
        changes = sorted([v.copy() for v in orig_changes], key=lambda v: v.address)
        updates, removals = [], []
        prev_addr = None
        for v in changes:
            if v.address == prev_addr:
                raise ValueError(f"duplicate entry {v} in changes")
            if v.voting_power < 0:
                raise ValueError(f"voting power can't be negative: {v.voting_power}")
            if v.voting_power > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    f"voting power can't be higher than {MAX_TOTAL_VOTING_POWER}: {v.voting_power}"
                )
            (removals if v.voting_power == 0 else updates).append(v)
            prev_addr = v.address
        return updates, removals

    def _verify_removals(self, deletes: List[Validator]) -> int:
        removed_power = 0
        for v in deletes:
            _, val = self.get_by_address(v.address)
            if val is None:
                raise ValueError(f"failed to find validator {v.address.hex()} to remove")
            removed_power += val.voting_power
        if len(deletes) > len(self.validators):
            raise ValueError("more deletes than validators")
        return removed_power

    def _verify_updates(self, updates: List[Validator], removed_power: int) -> int:
        """types/validator_set.go:395 — ensure max total power is never
        exceeded, checking deltas smallest-first."""

        def delta(u: Validator) -> int:
            _, val = self.get_by_address(u.address)
            return u.voting_power - val.voting_power if val else u.voting_power

        tvp_after_removals = self.total_voting_power() - removed_power
        for u in sorted(updates, key=delta):
            tvp_after_removals += delta(u)
            if tvp_after_removals > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    f"failed to add/update validator {u.address.hex()}: "
                    f"total voting power would exceed the max allowed {MAX_TOTAL_VOTING_POWER}"
                )
        return tvp_after_removals + removed_power

    def _compute_new_priorities(self, updates: List[Validator], updated_tvp: int) -> None:
        """New validators start at -1.125*tvp so they can't game rotation by
        re-bonding (types/validator_set.go:447)."""
        for u in updates:
            _, val = self.get_by_address(u.address)
            if val is None:
                u.proposer_priority = -(updated_tvp + (updated_tvp >> 3))
            else:
                u.proposer_priority = val.proposer_priority

    def _apply_updates(self, updates: List[Validator]) -> None:
        existing = self.validators
        merged: List[Validator] = []
        i = j = 0
        while i < len(existing) and j < len(updates):
            if existing[i].address < updates[j].address:
                merged.append(existing[i])
                i += 1
            else:
                merged.append(updates[j])
                if existing[i].address == updates[j].address:
                    i += 1
                j += 1
        merged.extend(existing[i:])
        merged.extend(updates[j:])
        self.validators = merged

    def _apply_removals(self, deletes: List[Validator]) -> None:
        delete_addrs = {v.address for v in deletes}
        self.validators = [v for v in self.validators if v.address not in delete_addrs]

    # -- aggregate (BLS) commit verification -------------------------------
    def verify_aggregate_commit(
        self,
        chain_id: str,
        block_id: BlockID,
        height: int,
        commit,
        needed: int,
        commit_vals: Optional["ValidatorSet"] = None,
    ) -> None:
        """ONE pairing check for an AggregateCommit: e(sum pk_bitmap, H(m)) .
        e(-g1, sigma) == 1, with power tallied against SELF.  `commit_vals`
        is the set the bitmap indexes (the commit's own set); when omitted
        it is this set (verify_commit).  The scheme's memo lets an async
        pre-verify lane (state sync, lite2, fast sync) that already paired
        this commit serve the check without pairing again."""
        commit.validate_basic()
        if height != commit.height:
            raise ValueError(f"invalid commit height: want {height}, got {commit.height}")
        if block_id != commit.block_id:
            raise ValueError(
                f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
            )
        bitmap_vals = commit_vals if commit_vals is not None else self
        if commit.signers.bits != bitmap_vals.size():
            raise ValueError(
                f"invalid aggregate commit -- wrong bitmap size: "
                f"{commit.signers.bits} vs {bitmap_vals.size()}"
            )
        from ..crypto.bls import scheme
        from .vote import is_bls_key

        idxs = commit.signers.true_indices()
        pks = []
        for i in idxs:
            pk = bitmap_vals.validators[i].pub_key
            if not is_bls_key(pk):
                raise ValueError(f"aggregate commit signer #{i} is not a BLS12-381 key")
            pks.append(pk.bytes())
        msg = commit.sign_message(chain_id)

        ok = scheme.memo_get(pks, msg, commit.agg_sig)
        if ok is None:
            ok = scheme.fast_aggregate_verify(pks, msg, commit.agg_sig)
            scheme.memo_put(pks, msg, commit.agg_sig, ok)
        if not ok:
            raise ValueError("invalid aggregate commit signature")

        if bitmap_vals is self:
            tallied = sum(self.validators[i].voting_power for i in idxs)
        else:
            # trusting and future checks: the bitmap indexes the commit's
            # set; credit only signers that are members of THIS set too
            tallied = 0
            for i in idxs:
                _, val = self.get_by_address(bitmap_vals.validators[i].address)
                if val is not None:
                    tallied += val.voting_power
        if tallied <= needed:
            raise NotEnoughVotingPowerError(got=tallied, needed=needed)

    # -- batched commit verification ---------------------------------------
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
        index — the validator index IS the table row.  Aggregate (BLS)
        commits route to the single-pairing check instead."""
        if isinstance(commit, AggregateCommit):
            self.verify_aggregate_commit(
                chain_id, block_id, height, commit,
                needed=self.total_voting_power() * 2 // 3,
            )
            return
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

        if isinstance(commit, AggregateCommit):
            # the signature is checked (and memoized) against new_set
            # above; this pass tallies the bitmap against the OLD set
            self.verify_aggregate_commit(
                chain_id, block_id, height, commit,
                needed=self.total_voting_power() * 2 // 3,
                commit_vals=new_set,
            )
            return

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
        commit_vals: Optional["ValidatorSet"] = None,
    ) -> None:
        """trustLevel of this (old, trusted) set signed the commit — the
        light-client skipping-verification core (types/validator_set.go:754).
        Validators are matched by address since the commit may belong to a
        different validator set.  For an AggregateCommit the bitmap indexes
        the commit's OWN set, so callers supply it as `commit_vals` (lite2
        always holds it: it is the untrusted header's set)."""
        if trust_numerator * 3 < trust_denominator or trust_numerator > trust_denominator:
            raise ValueError(
                f"trustLevel must be within [1/3, 1], given {trust_numerator}/{trust_denominator}"
            )
        if isinstance(commit, AggregateCommit):
            if commit_vals is None:
                raise ValueError(
                    "aggregate commit trusting-verify requires the commit's validator set"
                )
            self.verify_aggregate_commit(
                chain_id, block_id, height, commit,
                needed=self.total_voting_power() * trust_numerator // trust_denominator,
                commit_vals=commit_vals,
            )
            return
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

    def pubkey_table(self):
        """[V, 32] uint8 array of the raw pubkeys, set order; a row whose
        key is not 32 bytes (secp256k1, multisig) stays zero."""
        import numpy as np

        table = np.zeros((len(self.validators), 32), dtype=np.uint8)
        for i, v in enumerate(self.validators):
            pk = v.pub_key.bytes()
            if len(pk) == 32:
                table[i] = np.frombuffer(pk, dtype=np.uint8)
        return table

    def to_dict(self) -> dict:
        return {
            "validators": [v.to_dict() for v in self.validators],
            "proposer": self.proposer.to_dict() if self.proposer else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ValidatorSet":
        """The set as it was stored: order, powers, priorities and proposer
        as given, nothing checked (the JAX package's rule)."""
        new = cls()
        new.validators = [Validator.from_dict(v) for v in d["validators"]]
        new.proposer = Validator.from_dict(d["proposer"]) if d["proposer"] else None
        return new

    def __repr__(self) -> str:
        return f"ValidatorSet(n={len(self.validators)} tvp={self.total_voting_power()})"


codec.register("tm/ValidatorSet")(ValidatorSet)


def _verify_commit_basic(commit: Commit, height: int, block_id: BlockID) -> None:
    """types/validator_set.go:813."""
    commit.validate_basic()
    if height != commit.height:
        raise ValueError(f"invalid commit height: want {height}, got {commit.height}")
    if block_id != commit.block_id:
        raise ValueError(
            f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
        )
