"""Consensus: the BFT state machine, WAL, timeout ticker, replay (the
port's copy of tendermint_tpu/consensus; the reactor waits for p2p,
ROADMAP 1.7, and replay_file.py for the node's Config, ROADMAP 1.6)."""

from .types import (
    HeightVoteSet,
    RoundState,
    RoundStep,
)
from .ticker import TimeoutInfo, TimeoutTicker
from .wal import WAL, NilWAL
from .state import ConsensusState
from .replay import Handshaker

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
]
