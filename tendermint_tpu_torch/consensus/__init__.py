"""Consensus: the BFT state machine, WAL, timeout ticker, replay and the
WAL replay console (the port's copy of tendermint_tpu/consensus; the
reactor waits for p2p, ROADMAP 1.7)."""

from .types import (
    HeightVoteSet,
    RoundState,
    RoundStep,
)
from .ticker import TimeoutInfo, TimeoutTicker
from .wal import WAL, NilWAL
from .state import ConsensusState
from .replay import Handshaker
from .replay_file import run_replay_file

__all__ = [
    "ConsensusState",
    "Handshaker",
    "HeightVoteSet",
    "NilWAL",
    "RoundState",
    "RoundStep",
    "TimeoutInfo",
    "TimeoutTicker",
    "WAL",
    "run_replay_file",
]
