"""AggregateCommit: the O(1)-size BLS commit (the port's copy of
tendermint_tpu/types/agg_commit.py).

A classic Commit carries one CommitSig per validator: O(N) bytes and O(N)
signature verifies per consumer (lite2, state sync trust roots, fast-sync
replay, block validation).  When a validator set is uniformly BLS12-381,
commit assembly folds the +2/3 precommits into

    (height, round, block_id, signer bitmap, ONE 96-byte aggregate
     signature, one BFT timestamp)

verified by a single pairing check: e(sum of pk_i over the bitmap, H(m)) =
e(g1, sigma) with m the TIMESTAMP-FREE canonical precommit sign-bytes
(every folded precommit signed the same message:
types/canonical.py canonical_vote_sign_bytes_no_ts).

Soundness: FastAggregateVerify is safe against rogue keys only for
proof-of-possession-checked key sets; genesis validation checks a PoP for
every BLS validator (types/genesis.py), and so does the staking app's
rotation tx.

Two deliberate deltas from the reference Commit, as in the JAX package:
  * only FOR-BLOCK precommits fold into the bitmap: a nil precommit signs
    a different message, so ABCI `signed_last_block` reports nil voters as
    absent;
  * BFT time collapses to one power-weighted median timestamp computed at
    fold time, which `median_time` returns directly.  BLS votes sign
    timestamp-free bytes, so that median is the folder's word: block time
    on an all-BLS net is proposer-attested, bounded by header-time
    monotonicity and the propose-side clock-drift gate.

The encoding, hash and dict layout are the JAX package's byte for byte, so
stores and `agg_commit` frames carry across the two packages.
"""

from __future__ import annotations

from typing import List, Optional

from ..crypto import merkle
from ..encoding import codec
from ..encoding.proto import field_bytes, field_time, field_varint
from ..libs.bitarray import BitArray
from . import canonical
from .block import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig
from .vote import is_bls_key

BLS_SIGNATURE_SIZE = 96


class AggregateCommit:
    """Duck-types the Commit surface consumers touch (height, round,
    block_id, size, bit_array, hash, validate_basic, a signatures view).
    get_vote returns None: per-vote signatures no longer exist; laggards
    catch up through the reactor's `agg_commit` frame or fast sync, which
    verify this commit with the same single pairing."""

    def __init__(
        self,
        height: int,
        round_: int,
        block_id: BlockID,
        signers: BitArray,
        agg_sig: bytes,
        timestamp_ns: int,
    ):
        self.height = height
        self.round = round_
        self.block_id = block_id
        self.signers = signers
        self.agg_sig = bytes(agg_sig)
        self.timestamp_ns = timestamp_ns
        self._hash: Optional[bytes] = None
        self._sigs_view: Optional[List[CommitSig]] = None

    # -- Commit surface ----------------------------------------------------
    def size(self) -> int:
        return self.signers.bits

    def is_commit(self) -> bool:
        return self.signers.bits > 0

    def bit_array(self) -> BitArray:
        return self.signers.copy()

    def get_vote(self, val_idx: int):
        """Per-vote signatures are folded away: None, always."""
        return None

    @property
    def signatures(self) -> List[CommitSig]:
        """Read-only per-slot view for consumers that only look at presence
        (ABCI LastCommitInfo's signed_last_block).  The entries carry no
        address or signature: code that needs either routes on the commit
        type, as every verify path does."""
        if self._sigs_view is None:
            self._sigs_view = [
                CommitSig(
                    block_id_flag=(
                        BLOCK_ID_FLAG_COMMIT if self.signers.get_index(i) else BLOCK_ID_FLAG_ABSENT
                    ),
                    validator_address=b"",
                    timestamp_ns=0,
                    signature=b"",
                )
                for i in range(self.signers.bits)
            ]
        return self._sigs_view

    def sign_message(self, chain_id: str) -> bytes:
        """The aggregated message: timestamp-free canonical precommit
        sign-bytes for (chain_id, height, round, block_id)."""
        return canonical.canonical_vote_sign_bytes_no_ts(
            chain_id,
            canonical.PRECOMMIT_TYPE,
            self.height,
            self.round,
            self.block_id.hash,
            self.block_id.parts_header.total,
            self.block_id.parts_header.hash,
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.block_id.is_zero():
            raise ValueError("commit cannot be for nil block")
        if self.signers.bits <= 0:
            raise ValueError("empty signer bitmap")
        if self.signers.count() == 0:
            raise ValueError("no signers in aggregate commit")
        if len(self.agg_sig) != BLS_SIGNATURE_SIZE:
            raise ValueError(
                f"aggregate signature must be {BLS_SIGNATURE_SIZE} bytes, got {len(self.agg_sig)}"
            )
        if self.timestamp_ns <= 0:
            raise ValueError("aggregate commit missing timestamp")

    def encode(self) -> bytes:
        """Canonical byte layout (the hash input and the wire size)."""
        return (
            field_varint(1, self.height)
            + field_varint(2, self.round)
            + field_bytes(3, self.block_id.encode())
            + field_bytes(4, self.signers.to_bytes())
            + field_bytes(5, self.agg_sig)
            + field_time(6, self.timestamp_ns)
        )

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([self.encode()])
        return self._hash

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "block_id": self.block_id.to_dict(),
            "signers": self.signers.to_bytes(),
            "agg_sig": self.agg_sig,
            "timestamp_ns": self.timestamp_ns,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AggregateCommit":
        return cls(
            d["height"],
            d["round"],
            BlockID.from_dict(d["block_id"]),
            BitArray.from_bytes(d["signers"]),
            d["agg_sig"],
            d["timestamp_ns"],
        )

    def __repr__(self) -> str:
        return (
            f"AggregateCommit(H={self.height} R={self.round} "
            f"signers={self.signers.count()}/{self.signers.bits})"
        )


codec.register("tm/AggCommit")(AggregateCommit)


def commit_from_dict(d: Optional[dict]):
    """Decode either commit representation (storage and wire dicts)."""
    if d is None:
        return None
    if "agg_sig" in d:
        return AggregateCommit.from_dict(d)
    return Commit.from_dict(d)


def weighted_median_timestamp(commit: Commit, validators) -> int:
    """Power-weighted median of a classic commit's non-absent timestamps:
    the BFT-time rule of state.median_time, applied at fold time so the
    aggregate carries the block time the full commit would have given."""
    weighted = []
    total_power = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = validators.get_by_address(cs.validator_address)
        if val is not None:
            total_power += val.voting_power
            weighted.append((cs.timestamp_ns, val.voting_power))
    if total_power == 0:
        raise ValueError("weighted_median_timestamp: no commit signatures match the validator set")
    weighted.sort()
    median = total_power // 2
    acc = 0
    for ts, power in weighted:
        if acc + power > median:
            return ts
        acc += power
    raise AssertionError("unreachable: weighted median not found")


def set_is_uniform_bls(val_set) -> bool:
    """True iff EVERY validator key is BLS12-381: the aggregation gate.
    Mixed sets keep per-vote commits and per-scheme verify routing."""
    vals = val_set.validators
    return bool(vals) and all(is_bls_key(v.pub_key) for v in vals)


def fold_commit(commit: Commit, val_set, chain_id: str) -> Optional[AggregateCommit]:
    """Fold a classic +2/3 commit into an AggregateCommit, or None when it
    cannot fold (a mixed key set, nothing to fold, or a malformed
    signature): the caller keeps the per-vote commit in every None case, so
    aggregation turns itself off on mixed nets."""
    if not isinstance(commit, Commit) or not commit.signatures:
        return None
    if val_set.size() != len(commit.signatures):
        return None
    if not set_is_uniform_bls(val_set):
        return None
    signers = BitArray(val_set.size())
    sigs = []
    for idx, cs in enumerate(commit.signatures):
        if not cs.is_for_block():
            continue  # nil precommits sign a different message; absent is absent
        signers.set_index(idx, True)
        sigs.append(cs.signature)
    if not sigs:
        return None
    try:
        ts = weighted_median_timestamp(commit, val_set)
    except ValueError:
        return None
    from ..crypto.bls import scheme

    agg = scheme.aggregate_signatures(sigs)
    if agg is None:
        return None
    return AggregateCommit(commit.height, commit.round, commit.block_id, signers, agg, ts)


class AggregateLastCommit:
    """Restart adapter: consensus rebuilds rs.last_commit from the stored
    seen commit, but an aggregate seen commit has no per-vote signatures to
    rebuild a VoteSet from.  This stand-in covers the narrow surface that
    ConsensusState and the reactor touch on rs.last_commit: proposal
    assembly reuses the aggregate itself, and straggler precommits for the
    folded height are ignored (the commit is +2/3 by construction, checked
    against the stored validator set on load)."""

    def __init__(self, commit: AggregateCommit):
        self.commit = commit
        self.height = commit.height
        self.round = commit.round
        self.signed_msg_type = canonical.PRECOMMIT_TYPE

    def has_two_thirds_majority(self) -> bool:
        return True

    def two_thirds_majority(self):
        return self.commit.block_id, True

    def make_commit(self) -> AggregateCommit:
        return self.commit

    def add_vote(self, vote, verify: bool = True) -> bool:
        return False  # nothing to add a straggler to; duplicate-safe

    def has_all(self) -> bool:
        return self.commit.signers.is_full()

    def get_by_index(self, val_idx: int):
        return None

    def bit_array(self) -> BitArray:
        return self.commit.bit_array()

    def size(self) -> int:
        return self.commit.size()

    def missing_votes(self, peer_bits):
        return []

    def select_votes(self, bits):
        return []

    def bits_we_lack(self, their_bits) -> BitArray:
        return BitArray(0)

    def __repr__(self) -> str:
        return f"AggregateLastCommit({self.commit!r})"
