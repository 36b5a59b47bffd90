"""TwinSigner: the double-signing byzantine validator (the port's copy of
tendermint_tpu/chaos/twin.py).

The "twin" attack (two copies of one validator key signing conflicting
messages) is THE fault the accountability pipeline exists for, and until
now that pipeline — VoteSet conflict detection -> ErrVoteConflictingVotes
-> DuplicateVoteEvidence -> EvidencePool -> evidence gossip -> block
inclusion -> BeginBlock `byzantine_validators` — had only ever been driven
by hand-crafted votes in unit tests, never by an actual byzantine NODE.

TwinSigner wraps a real privval (FilePV or MockPV) and deliberately
BYPASSES the last-sign-state guard: it signs whatever it is asked, with
the raw key, never consulting or updating FilePVLastSignState.  That is
precisely the protection a correctly-operated validator relies on and a
twin deployment loses.  `install_twin` then arms the node: every time the
node's own non-nil prevote enters its state machine, the twin signs a
CONFLICTING prevote (same H/R/type, perturbed BlockID) and broadcasts it
to all peers over the consensus vote channel.  Honest peers detect the
conflict in their vote sets, pool the evidence, gossip it, and the next
proposer commits it — which the chaos checker asserts end to end.

Expected twin fate: once a peer that stored the CONFLICTING vote first
gossips it back, the twin sees a conflict from its own address and its
consensus halts (state.go: "conflicting vote from ourselves") — reference
behavior for a double-signer, and why the invariant checker treats the
twin as liveness-exempt (agreement still applies to every block it did
commit).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional

from ..libs.log import get_logger
from ..types.block import BlockID, PartSetHeader
from ..types.canonical import PREVOTE_TYPE
from ..types.priv_validator import PrivValidator, challenge_sign_bytes
from ..types.proposal import Proposal
from ..types.vote import Vote

#: keep the equivocation memory bounded; a twin rarely survives past a
#: handful of heights anyway (see module docstring)
_MAX_SEEN = 64


class TwinSigner(PrivValidator):
    """A privval that never refuses to sign.  Wraps FilePV or MockPV and
    signs with the raw key, skipping the last-sign-state double-sign
    guard entirely (privval/file.go:296's CheckHRS is the thing being
    deliberately bypassed)."""

    def __init__(self, inner):
        self._inner = inner
        self._priv = self._raw_priv_key(inner)
        self.equivocations = 0

    @staticmethod
    def _raw_priv_key(inner):
        # FilePV keeps the key under .key.priv_key; MockPV under .priv_key
        key_half = getattr(inner, "key", None)
        if key_half is not None and hasattr(key_half, "priv_key"):
            return key_half.priv_key
        pk = getattr(inner, "priv_key", None)
        if pk is None:
            raise TypeError(
                f"TwinSigner needs a local key to bypass the guard; "
                f"{type(inner).__name__} exposes none (remote signers "
                f"cannot be twinned from the node side)"
            )
        return pk

    # -- PrivValidator -----------------------------------------------------

    def get_pub_key(self):
        return self._inner.get_pub_key()

    def address(self) -> bytes:
        return self.get_pub_key().address()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        # no CheckHRS, no persisted state: the guard is the point
        vote.signature = self._priv.sign(vote.sign_bytes(chain_id))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        proposal.signature = self._priv.sign(proposal.sign_bytes(chain_id))

    def sign_challenge(self, nonce: bytes) -> bytes:
        return self._priv.sign(challenge_sign_bytes(nonce))

    # -- equivocation ------------------------------------------------------

    def conflicting_vote(self, chain_id: str, vote: Vote) -> Vote:
        """A validly-signed vote for the same H/R/type but a DIFFERENT
        (well-formed) BlockID — the other half of the duplicate-vote
        evidence.  The perturbation is deterministic (bitwise complement)
        so reruns produce identical equivocations."""
        bid = vote.block_id
        if bid.hash:
            alt_hash = bytes(b ^ 0xFF for b in bid.hash)
        else:
            alt_hash = b"\x55" * 32
        ph = bid.parts_header
        alt_parts = PartSetHeader(
            max(1, ph.total),
            bytes(b ^ 0xFF for b in ph.hash) if ph.hash else b"\x55" * 32,
        )
        twin_vote = replace(
            vote,
            block_id=BlockID(alt_hash, alt_parts),
            signature=b"",
            _wire=None,  # encode-once caches belong to the original vote
            _legacy_frame=None,
        )
        self.sign_vote(chain_id, twin_vote)
        self.equivocations += 1
        return twin_vote

    def __repr__(self) -> str:
        return f"TwinSigner({self._inner!r})"


def install_twin(node, vote_types=(PREVOTE_TYPE,)) -> None:
    """Arm a running node as a twin: observe its own votes and broadcast a
    conflicting one per (height, round) to every peer.  Requires the
    node's priv_validator to already be a TwinSigner (Node wraps it when
    `[chaos] enabled` + `[chaos] twin`) and a live p2p switch."""
    from ..consensus.reactor import VOTE_CHANNEL, _enc

    cs, sw = node.consensus, node.switch
    twin: TwinSigner = node.priv_validator
    if not isinstance(twin, TwinSigner):
        raise TypeError("install_twin: node.priv_validator is not a TwinSigner")
    if sw is None:
        raise RuntimeError("install_twin: twin equivocation needs a p2p switch")
    addr = twin.get_pub_key().address()
    chain_id = node.genesis_doc.chain_id
    recorder = node.flight_recorder
    metrics = getattr(node.metrics_provider, "chaos", None)
    log = get_logger("chaos.twin")
    seen: set = set()

    def _on_vote(vote: Vote) -> None:
        if vote.validator_address != addr or vote.type not in vote_types:
            return
        if vote.block_id.is_zero():
            return  # equivocating against nil proves nothing interesting
        key = (vote.height, vote.round, vote.type)
        if key in seen:
            return
        if len(seen) >= _MAX_SEEN:
            seen.clear()
        seen.add(key)
        conflict = twin.conflicting_vote(chain_id, vote)
        recorder.record(
            "chaos.twin_vote", height=vote.height, round=vote.round, type=vote.type
        )
        if metrics is not None:
            metrics.twin_votes.inc()
        log.info(
            "twin equivocating", height=vote.height, round=vote.round,
            real=vote.block_id.hash.hex()[:12], twin=conflict.block_id.hash.hex()[:12],
        )
        # byzantine trace context on the equivocation frame: an absurd hop
        # count and a far-future origin timestamp.  Honest receivers must
        # CLAMP both (reactor._trace_recv) — counted, never trusted into
        # skew estimation — which chip_smoke.py phase 17 asserts end to end.
        frame = _enc(
            "vote",
            {
                "vote": conflict.to_dict(),
                "o": "twin-forged-origin",
                "ow": time.time_ns() + 600 * 1_000_000_000,
                "hp": 1 << 20,
            },
        )
        sw.spawn(sw.broadcast(VOTE_CHANNEL, frame), f"twin-equivocate-{vote.height}")

    cs.on_vote.append(_on_vote)
    log.info("twin installed: this node WILL double-sign", address=addr.hex()[:12])
