"""File-backed private validator with persisted last-sign state (the port's
copy of tendermint_tpu/privval/file.py; the key and state files are the
same JSON, byte for byte, so either package loads the other's).

Reference parity: privval/file.go — FilePVKey:42, FilePVLastSignState:71
(+ CheckHRS:88), FilePV:145, LoadOrGenFilePV:185, signVote:296 /
signProposal:322 (same-HRS re-sign only when the request differs solely by
timestamp), save discipline: the last-sign state is fsync-persisted BEFORE
a signature is released (privval/file.go:415 saveSigned) so a crash
between signing and any other durable write can never lead to a
conflicting re-sign after restart.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, replace
from typing import Tuple

from ..crypto.keys import Ed25519PrivKey as PrivKey
from ..crypto.keys import Ed25519PubKey as PubKey
from ..crypto.keys import generate_priv_key, privkey_from_dict, pubkey_from_dict
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.priv_validator import PrivValidator
from ..types.proposal import Proposal
from ..types.vote import Vote

# sign-step ordering inside one (height, round) (privval/file.go:33-40)
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {PREVOTE_TYPE: STEP_PREVOTE, PRECOMMIT_TYPE: STEP_PRECOMMIT}


class DoubleSignError(Exception):
    """Refusing to sign: the request regresses or conflicts with the
    persisted last-sign state."""


def _atomic_write_json(path: str, obj: dict) -> None:
    """tempfile + fsync + rename + DIRECTORY fsync — the state file must
    never be torn (libs/tempfile.WriteFileAtomic equivalent).  The dir
    fsync matters: rename atomicity without it can lose the ENTIRE file
    on power loss (the new directory entry never reaches the platter),
    and for the last-sign state a vanished file after a crash is a
    double-sign vector — the restarted node would believe it never
    signed."""
    from ..libs.autofile import fsync_dir

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".pv-")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh, indent=2)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(path)


@dataclass
class FilePVKey:
    """privval/file.go:42 — the immutable key half.  This slice carries
    ed25519 keys; another type in a key file raises TypeError naming the
    ROADMAP item that ports it (privkey_from_dict)."""

    address: bytes
    pub_key: PubKey
    priv_key: PrivKey
    file_path: str = ""

    def save(self) -> None:
        _atomic_write_json(
            self.file_path,
            {
                "address": self.address.hex().upper(),
                "pub_key": {
                    "type": self.pub_key.to_dict()["type"],
                    "value": self.pub_key.bytes().hex(),
                },
                "priv_key": {
                    "type": self.priv_key.TYPE,
                    "value": self.priv_key.bytes().hex(),
                },
            },
        )

    @classmethod
    def load(cls, path: str) -> "FilePVKey":
        with open(path) as fh:
            d = json.load(fh)
        priv = privkey_from_dict(
            {"type": d["priv_key"]["type"], "value": bytes.fromhex(d["priv_key"]["value"])}
        )
        pub = pubkey_from_dict(
            {"type": d["pub_key"]["type"], "value": bytes.fromhex(d["pub_key"]["value"])}
        )
        return cls(bytes.fromhex(d["address"]), pub, priv, path)


@dataclass
class FilePVLastSignState:
    """privval/file.go:71 — the mutable double-sign protection half."""

    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""
    timestamp_ns: int = 0
    file_path: str = ""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """privval/file.go:88 — errors on HRS regression; returns True if
        (height, round, step) equals the last signed HRS (caller may then
        only re-release the same signature)."""
        if self.height > height:
            raise DoubleSignError(f"height regression. Got {height}, last height {self.height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}. Got {round_}, last round {self.round}"
                )
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at height {height} round {round_}. "
                        f"Got {step}, last step {self.step}"
                    )
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError("no sign_bytes recorded for matching HRS")
                    return True
        return False

    def save(self) -> None:
        _atomic_write_json(
            self.file_path,
            {
                "height": self.height,
                "round": self.round,
                "step": self.step,
                "signature": self.signature.hex(),
                "sign_bytes": self.sign_bytes.hex(),
                "timestamp_ns": self.timestamp_ns,
            },
        )

    @classmethod
    def load(cls, path: str) -> "FilePVLastSignState":
        with open(path) as fh:
            d = json.load(fh)
        return cls(
            height=d["height"],
            round=d["round"],
            step=d["step"],
            signature=bytes.fromhex(d["signature"]),
            sign_bytes=bytes.fromhex(d["sign_bytes"]),
            timestamp_ns=d.get("timestamp_ns", 0),
            file_path=path,
        )


class FilePV(PrivValidator):
    """privval/file.go:145 — key file + persisted last-sign state."""

    def __init__(self, key: FilePVKey, last_sign_state: FilePVLastSignState):
        self.key = key
        self.last_sign_state = last_sign_state

    # -- construction ------------------------------------------------------

    @classmethod
    def generate(cls, key_file: str, state_file: str, key_type: str = "ed25519") -> "FilePV":
        priv = generate_priv_key(key_type)
        key = FilePVKey(priv.pub_key().address(), priv.pub_key(), priv, key_file)
        return cls(key, FilePVLastSignState(file_path=state_file))

    @classmethod
    def load(cls, key_file: str, state_file: str) -> "FilePV":
        key = FilePVKey.load(key_file)
        if os.path.exists(state_file):
            lss = FilePVLastSignState.load(state_file)
            lss.file_path = state_file
        else:
            lss = FilePVLastSignState(file_path=state_file)
        return cls(key, lss)

    @classmethod
    def load_or_generate(
        cls, key_file: str, state_file: str, key_type: str = "ed25519"
    ) -> "FilePV":
        """privval/file.go:185 LoadOrGenFilePV."""
        if os.path.exists(key_file):
            return cls.load(key_file, state_file)
        pv = cls.generate(key_file, state_file, key_type)
        pv.save()
        return pv

    def save(self) -> None:
        self.key.save()
        self.last_sign_state.save()

    # -- PrivValidator -----------------------------------------------------

    def get_pub_key(self) -> PubKey:
        return self.key.pub_key

    def address(self) -> bytes:
        return self.key.address

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """privval/file.go:296 signVote (sign-bytes through
        Vote.sign_bytes_for_key, as every verification path routes them)."""
        step = _VOTE_STEP.get(vote.type)
        if step is None:
            raise ValueError(f"unknown vote type {vote.type}")
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(vote.height, vote.round, step)
        sign_bytes = vote.sign_bytes_for_key(chain_id, self.key.pub_key)

        if same_hrs:
            # Idempotent re-sign (e.g. WAL replay asks again): identical
            # request -> same signature; timestamp-only diff -> release the
            # previously-signed timestamp+signature; anything else is a
            # conflicting double-sign attempt.
            if sign_bytes == lss.sign_bytes:
                vote.signature = lss.signature
                return
            ts, ok = self._only_differs_by_timestamp(vote, chain_id)
            if ok:
                vote.timestamp_ns = ts
                vote.signature = lss.signature
                return
            raise DoubleSignError("conflicting data: same HRS, different vote")

        sig = self.key.priv_key.sign(sign_bytes)
        self._save_signed(vote.height, vote.round, step, sign_bytes, sig, vote.timestamp_ns)
        vote.signature = sig

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        """privval/file.go:322 signProposal."""
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(proposal.height, proposal.round, STEP_PROPOSE)
        sign_bytes = proposal.sign_bytes(chain_id)

        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                proposal.signature = lss.signature
                return
            ts, ok = self._proposal_only_differs_by_timestamp(proposal, chain_id)
            if ok:
                proposal.timestamp_ns = ts
                proposal.signature = lss.signature
                return
            raise DoubleSignError("conflicting data: same HRS, different proposal")

        sig = self.key.priv_key.sign(sign_bytes)
        self._save_signed(
            proposal.height, proposal.round, STEP_PROPOSE, sign_bytes, sig, proposal.timestamp_ns
        )
        proposal.signature = sig

    def sign_challenge(self, nonce: bytes) -> bytes:
        """Connection proof-of-possession (domain-separated — cannot be
        confused with vote/proposal bytes, so no double-sign state)."""
        from ..types.priv_validator import challenge_sign_bytes

        return self.key.priv_key.sign(challenge_sign_bytes(nonce))

    # -- internals ---------------------------------------------------------

    def _save_signed(
        self, height: int, round_: int, step: int, sign_bytes: bytes, sig: bytes, ts_ns: int
    ) -> None:
        """privval/file.go:415 — persist BEFORE the signature escapes.

        If the save fails (ENOSPC/EIO on the state file), the in-memory
        state is ROLLED BACK and the error propagates: the signature has
        not escaped this process, so refusing the sign is safe — and the
        rollback keeps the privval able to sign this HRS once the disk
        heals, instead of wedging on a phantom "conflicting" entry for a
        signature nobody ever saw.  (`_atomic_write_json` is atomic: on
        failure the on-disk state is still the OLD one the rollback
        restores consistency with.)"""
        lss = self.last_sign_state
        prev = (lss.height, lss.round, lss.step, lss.sign_bytes, lss.signature, lss.timestamp_ns)
        lss.height = height
        lss.round = round_
        lss.step = step
        lss.sign_bytes = sign_bytes
        lss.signature = sig
        lss.timestamp_ns = ts_ns
        try:
            lss.save()
        except BaseException:
            (lss.height, lss.round, lss.step,
             lss.sign_bytes, lss.signature, lss.timestamp_ns) = prev
            raise

    def _only_differs_by_timestamp(self, vote: Vote, chain_id: str) -> Tuple[int, bool]:
        """privval/file.go:438 checkVotesOnlyDifferByTimestamp: rebuild the
        request's sign-bytes using the persisted timestamp; equality means
        the vote is the same modulo time."""
        lss = self.last_sign_state
        candidate = replace(vote, timestamp_ns=lss.timestamp_ns, signature=b"")
        return (
            lss.timestamp_ns,
            candidate.sign_bytes_for_key(chain_id, self.key.pub_key) == lss.sign_bytes,
        )

    def _proposal_only_differs_by_timestamp(
        self, proposal: Proposal, chain_id: str
    ) -> Tuple[int, bool]:
        lss = self.last_sign_state
        candidate = replace(proposal, timestamp_ns=lss.timestamp_ns, signature=b"")
        return lss.timestamp_ns, candidate.sign_bytes(chain_id) == lss.sign_bytes

    def __repr__(self) -> str:
        return f"FilePV({self.key.address.hex()[:12]})"


def load_or_gen_file_pv(config) -> FilePV:
    """DefaultNewNode's privval hook (node/node.go:115) from a Config.  A
    `base.key_type` other than ed25519 raises generate_priv_key's TypeError
    naming the ROADMAP item that ports it (1.8 or 1.9)."""
    return FilePV.load_or_generate(
        config.priv_validator_key_file(),
        config.priv_validator_state_file(),
        getattr(config.base, "key_type", "ed25519"),
    )
