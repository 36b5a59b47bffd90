"""Round state + height vote set (the port's copy of
tendermint_tpu/consensus/types.py).

Reference parity: consensus/types/round_state.go (RoundStepType:20,
RoundState:67), consensus/types/height_vote_set.go:38.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..types.block import BlockID
from ..types.validator import ValidatorSet
from ..types.vote import Vote
from ..types.vote_set import VoteSet
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE, is_vote_type_valid


class RoundStep:
    """Ordered step enum (round_state.go:20)."""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8

    NAMES = {
        1: "NewHeight",
        2: "NewRound",
        3: "Propose",
        4: "Prevote",
        5: "PrevoteWait",
        6: "Precommit",
        7: "PrecommitWait",
        8: "Commit",
    }


class GotVoteFromUnwantedRoundError(Exception):
    """height_vote_set.go:19."""


class HeightVoteSet:
    """All VoteSets for one height: rounds 0..round, plus up to 2 catchup
    rounds per peer (height_vote_set.go:38)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self.round_vote_sets: Dict[int, Tuple[VoteSet, VoteSet]] = {}
        self.peer_catchup_rounds: Dict[str, List[int]] = {}
        self._add_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ in self.round_vote_sets:
            raise ValueError("add_round for an existing round")
        prevotes = VoteSet(self.chain_id, self.height, round_, PREVOTE_TYPE, self.val_set)
        precommits = VoteSet(self.chain_id, self.height, round_, PRECOMMIT_TYPE, self.val_set)
        self.round_vote_sets[round_] = (prevotes, precommits)

    def set_round(self, round_: int) -> None:
        """Track up to round (also round+1 for skipping)."""
        if self.round != 0 and round_ < self.round + 1:
            raise ValueError("set_round must increment the round")
        for r in range(self.round + 1, round_ + 1):
            if r not in self.round_vote_sets:
                self._add_round(r)
        self.round = round_

    def add_vote(self, vote: Vote, peer_id: str = "", verify: bool = True) -> bool:
        if not is_vote_type_valid(vote.type):
            return False
        vs = self._get_vote_set(vote.round, vote.type)
        if vs is None:
            rounds = self.peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < 2:
                self._add_round(vote.round)
                vs = self._get_vote_set(vote.round, vote.type)
                rounds.append(vote.round)
            else:
                raise GotVoteFromUnwantedRoundError(
                    "peer has sent a vote that does not match our round for more than one round"
                )
        return vs.add_vote(vote, verify=verify)

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, PREVOTE_TYPE)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, PRECOMMIT_TYPE)

    def pol_info(self) -> Tuple[int, Optional[BlockID]]:
        """Last round with a prevote maj23, or (-1, None)
        (height_vote_set.go:147)."""
        for r in range(self.round, -1, -1):
            vs = self._get_vote_set(r, PREVOTE_TYPE)
            if vs is not None:
                block_id, ok = vs.two_thirds_majority()
                if ok:
                    return r, block_id
        return -1, None

    def _get_vote_set(self, round_: int, vote_type: int) -> Optional[VoteSet]:
        pair = self.round_vote_sets.get(round_)
        if pair is None:
            return None
        return pair[0] if vote_type == PREVOTE_TYPE else pair[1]

    def set_peer_maj23(self, round_: int, vote_type: int, peer_id: str, block_id: BlockID) -> None:
        if not is_vote_type_valid(vote_type):
            raise ValueError(f"invalid vote type {vote_type}")
        vs = self._get_vote_set(round_, vote_type)
        if vs is not None:
            vs.set_peer_maj23(peer_id, block_id)


@dataclass
class RoundState:
    """The public snapshot of consensus internals (round_state.go:67) —
    exported to the reactor, RPC dump_consensus_state, and the WAL."""

    height: int = 0
    round: int = 0
    step: int = RoundStep.NEW_HEIGHT
    start_time: float = 0.0
    commit_time: float = 0.0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[object] = None
    proposal_block: Optional[object] = None
    proposal_block_parts: Optional[object] = None
    locked_round: int = -1
    locked_block: Optional[object] = None
    locked_block_parts: Optional[object] = None
    valid_round: int = -1
    valid_block: Optional[object] = None
    valid_block_parts: Optional[object] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False
    # Aggregate-commit catchup (types/agg_commit.py): a VERIFIED aggregate
    # commit for this height whose block is still being fetched; the
    # block-part completion path finalizes from it, since a folded commit
    # has no per-vote precommits to drive the vote tally.
    catchup_agg_commit: Optional[object] = None

    def event_dict(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "step": RoundStep.NAMES.get(self.step, str(self.step)),
        }
