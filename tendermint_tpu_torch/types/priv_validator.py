"""PrivValidator interface, the multi-key RotatingPV and the test mock
(the port's copy of tendermint_tpu/types/priv_validator.py).

Reference parity: types/priv_validator.go:14 (GetPubKey/SignVote/
SignProposal), MockPV:33.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..crypto.keys import Ed25519PrivKey, PubKey
from .proposal import Proposal
from .vote import Vote


# Domain separator for connection-liveness challenges (remote signer
# proof-of-possession).  Distinct from any canonical vote/proposal
# encoding, so a challenge signature can never be replayed as a vote.
CHALLENGE_PREFIX = b"\x00\x00privval-conn-challenge\x00"


def challenge_sign_bytes(nonce: bytes) -> bytes:
    if len(nonce) != 32:
        raise ValueError("challenge nonce must be 32 bytes")
    return CHALLENGE_PREFIX + nonce


class PrivValidator(ABC):
    """Signs votes and proposals, never double-signs."""

    @abstractmethod
    def get_pub_key(self) -> PubKey: ...

    @abstractmethod
    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """Sets vote.signature in place (reference mutates the same way)."""

    @abstractmethod
    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None: ...

    def sign_challenge(self, nonce: bytes) -> bytes:
        """Prove possession of the validator key over a fresh nonce
        (domain-separated; used by SignerClient reconnect pinning)."""
        raise NotImplementedError


class RotatingPV(PrivValidator):
    """A multi-key privval for live consensus-key migrations.

    Holds an ordered list of candidate signers (e.g. the node's ed25519
    FilePV/MockPV plus another key's) and signs with whichever key is a
    member of the CURRENT validator set — consensus notifies it at every
    height boundary via `observe_validators` (consensus/state.py
    update_to_state), which is exactly when an ABCI-driven rotation
    becomes effective.  Until a set containing one of its keys is
    observed, the first candidate is active (the pre-migration identity).

    Double-sign safety is inherited: each candidate signer keeps its own
    last-signed state, and at any given height exactly one candidate's
    address is in the set (the staking app's rotate tx swaps the old key
    out and the new key in atomically in one end_block).
    """

    def __init__(self, *candidates: PrivValidator):
        if not candidates:
            raise ValueError("RotatingPV needs at least one candidate signer")
        self.candidates = list(candidates)
        self._active = candidates[0]

    def observe_validators(self, val_set) -> None:
        for pv in self.candidates:
            if val_set.has_address(pv.get_pub_key().address()):
                self._active = pv
                return
        # none of our keys is in the set: keep the current signer (the
        # node is simply not a validator right now — consensus membership
        # checks handle that; switching would be arbitrary)

    @property
    def active(self) -> PrivValidator:
        return self._active

    def get_pub_key(self) -> PubKey:
        return self._active.get_pub_key()

    def address(self) -> bytes:
        return self.get_pub_key().address()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        self._active.sign_vote(chain_id, vote)

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        self._active.sign_proposal(chain_id, proposal)

    def sign_challenge(self, nonce: bytes) -> bytes:
        return self._active.sign_challenge(nonce)

    def __repr__(self) -> str:
        return f"RotatingPV(active={self._active!r}, n={len(self.candidates)})"


class MockPV(PrivValidator):
    """In-memory signer for tests (types/priv_validator.go:33).
    `break_*` flags corrupt sign-bytes for byzantine tests
    (erroringMockPV equivalents)."""

    def __init__(self, priv_key=None, break_proposal_signing: bool = False, break_vote_signing: bool = False):
        self.priv_key = priv_key or Ed25519PrivKey.generate()
        self.break_proposal_signing = break_proposal_signing
        self.break_vote_signing = break_vote_signing

    def get_pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    def address(self) -> bytes:
        return self.get_pub_key().address()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_vote_signing else chain_id
        vote.signature = self.priv_key.sign(
            vote.sign_bytes_for_key(use_chain_id, self.get_pub_key())
        )

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        use_chain_id = "incorrect-chain-id" if self.break_proposal_signing else chain_id
        proposal.signature = self.priv_key.sign(proposal.sign_bytes(use_chain_id))

    def sign_challenge(self, nonce: bytes) -> bytes:
        return self.priv_key.sign(challenge_sign_bytes(nonce))

    def __repr__(self) -> str:
        return f"MockPV({self.address().hex()[:12]})"
