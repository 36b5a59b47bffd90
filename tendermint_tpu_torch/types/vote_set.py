"""VoteSet: collects signatures for one (height, round, type) (a copy of
tendermint_tpu/types/vote_set.py).

Reference parity: types/vote_set.go (VoteSet:61, addVote:153,
addVerifiedVote:229, SetPeerMaj23:307, MakeCommit:553).  Keeps the
reference's two-storage design — `votes` (canonical, one per validator) and
`votes_by_block` (per-block tallies incl. peer-claimed maj23 blocks) — which
is what bounds memory under double-signing.

`add_vote` checks a signature on the host by default; vote ingress instead
verifies votes through the AsyncBatchVerifier and adds them with
verify=False, so trickling votes still coalesce into device batches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..libs.bitarray import BitArray
from .block import BlockID, Commit, CommitSig
from .canonical import PRECOMMIT_TYPE
from .evidence import DuplicateVoteEvidence
from .validator import ValidatorSet
from .vote import ErrVoteConflictingVotes, Vote, VoteError


class _BlockVotes:
    """Votes for one block key (types/vote_set.go:582)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: List[Optional[Vote]] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]


class VoteSet:
    def __init__(
        self, chain_id: str, height: int, round_: int, signed_msg_type: int, val_set: ValidatorSet
    ):
        if height == 0:
            raise ValueError("cannot make VoteSet for height == 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.votes_bit_array = BitArray(val_set.size())
        self.votes: List[Optional[Vote]] = [None] * val_set.size()
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    def size(self) -> int:
        return self.val_set.size()

    # -- adding votes ------------------------------------------------------
    def add_vote(self, vote: Optional[Vote], verify: bool = True) -> bool:
        """Returns True if the vote is valid and new; False for duplicates.
        Raises VoteError subtypes otherwise (types/vote_set.go:142).

        With verify=False the signature is assumed already checked by the
        BatchVerifier (consensus calls it this way after batch results
        resolve); all structural validation still runs.
        """
        if vote is None:
            raise VoteError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise VoteError("invalid validator index: < 0")
        if not val_addr:
            raise VoteError("invalid validator address: empty")
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.signed_msg_type
        ):
            raise VoteError(
                f"unexpected step: expected {self.height}/{self.round}/{self.signed_msg_type}, "
                f"got {vote.height}/{vote.round}/{vote.type}"
            )

        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise VoteError(
                f"invalid validator index: cannot find validator {val_index} "
                f"in valSet of size {self.val_set.size()}"
            )
        if val_addr != lookup_addr:
            raise VoteError(
                f"invalid validator address: vote address {val_addr.hex()} does not match "
                f"{lookup_addr.hex()} for index {val_index}"
            )

        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # exact duplicate
            raise VoteError(f"non-deterministic signature: existing {existing}, new {vote}")

        if verify:
            vote.verify(self.chain_id, val.pub_key)

        added, conflicting = self._add_verified_vote(vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ErrVoteConflictingVotes(
                DuplicateVoteEvidence.from_votes(val.pub_key, conflicting, vote)
            )
        if not added:
            raise VoteError("expected to add non-conflicting vote")
        return True

    def _get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(
        self, vote: Vote, block_key: bytes, voting_power: int
    ) -> Tuple[bool, Optional[Vote]]:
        """types/vote_set.go:229."""
        val_index = vote.validator_index
        conflicting: Optional[Vote] = None

        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                raise VoteError("add_verified_vote does not expect duplicate votes")
            conflicting = existing
            # Replace the canonical vote if this block is the maj23 one.
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power

        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                # Conflict and no peer claims this block is special — reject.
                return False, conflicting
        else:
            if conflicting is not None:
                # Untracked block with a conflicting vote — forget it.
                return False, conflicting
            bv = _BlockVotes(peer_maj23=False, num_validators=self.val_set.size())
            self.votes_by_block[block_key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            # Promote this block's votes into the canonical list.
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v

        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims to have seen +2/3 for block_id
        (types/vote_set.go:307)."""
        block_key = block_id.key()
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise VoteError(
                f"setPeerMaj23: received conflicting blockID from peer {peer_id}: "
                f"got {block_id}, expected {existing}"
            )
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes(
                peer_maj23=True, num_validators=self.val_set.size()
            )

    # -- queries -----------------------------------------------------------
    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv else None

    def get_by_index(self, val_index: int) -> Optional[Vote]:
        if val_index < 0 or val_index >= len(self.votes):
            return None
        return self.votes[val_index]

    def missing_votes(self, peer_bits: Optional[BitArray]) -> List[Vote]:
        """Every canonical vote we hold that `peer_bits` says the peer
        lacks, in validator-index order — the send set of one batched
        gossip wakeup (vs the reference's one-random-vote-per-tick
        PickSendVote, reactor.go:1036)."""
        missing = self.votes_bit_array.sub(peer_bits) if peer_bits is not None else self.votes_bit_array
        return [
            v
            for i in missing.true_indices()
            if (v := self.votes[i]) is not None
        ]

    def bits_we_lack(self, their_bits: Optional[BitArray]) -> BitArray:
        """Bits set in `their_bits` but absent from our canonical set — what
        a `vote_summary` receiver should pull from the sender.  Bits past
        our validator-set size (a peer-supplied bitmap is attacker-sized)
        are dropped, never allocated for."""
        if their_bits is None:
            return BitArray(0)
        n = min(their_bits.bits, self.val_set.size())
        theirs = BitArray(n)
        theirs._v[:n] = their_bits._v[:n]
        return theirs.sub(self.votes_bit_array)

    def select_votes(self, bits: Optional[BitArray]) -> List[Vote]:
        """Canonical votes at the true indices of `bits` (clamped to the
        set size) — the serve side of a relay `vote_pull`.  Indices we hold
        no vote for are skipped: the puller's bitmap is its claim about the
        SENDER of a summary, which may not be us."""
        if bits is None:
            return []
        n = min(bits.bits, len(self.votes))
        return [
            v
            for i in bits.true_indices()
            if i < n and (v := self.votes[i]) is not None
        ]

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        idx, val = self.val_set.get_by_address(address)
        if val is None:
            raise VoteError("get_by_address: address not in validator set")
        return self.votes[idx]

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def is_commit(self) -> bool:
        return self.signed_msg_type == PRECOMMIT_TYPE and self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> Tuple[Optional[BlockID], bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return None, False

    # -- commit extraction -------------------------------------------------
    def make_commit(self) -> Commit:
        """types/vote_set.go:553."""
        if self.signed_msg_type != PRECOMMIT_TYPE:
            raise VoteError("cannot make_commit() unless VoteSet type is precommit")
        if self.maj23 is None:
            raise VoteError("cannot make_commit() unless a blockhash has +2/3")
        commit_sigs = [
            v.commit_sig() if v is not None else CommitSig.absent() for v in self.votes
        ]
        return Commit(self.height, self.round, self.maj23, commit_sigs)

    def __repr__(self) -> str:
        frac = self.sum / max(self.val_set.total_voting_power(), 1)
        return (
            f"VoteSet{{H:{self.height} R:{self.round} T:{self.signed_msg_type} "
            f"+2/3:{self.maj23} {self.sum} ({frac:.2f})}}"
        )
