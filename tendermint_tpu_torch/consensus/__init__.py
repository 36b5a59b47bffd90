"""Consensus: the BFT state machine, WAL, timeout ticker, replay, the WAL
replay console and the reactor (the port's copy of
tendermint_tpu/consensus; the reactor is imported from consensus.reactor,
as in the JAX package)."""

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
