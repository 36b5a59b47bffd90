"""Chain state and its store: State, make_genesis_state, median_time and
StateStore (the port's copies of tendermint_tpu/state/state.py and
store.py)."""

from .state import State, make_genesis_state, median_time
from .store import StateStore

__all__ = ["State", "StateStore", "make_genesis_state", "median_time"]
