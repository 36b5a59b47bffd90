"""Chain state and its store: State, make_genesis_state, median_time and
StateStore (the port's copies of tendermint_tpu/state/state.py and
store.py); block validation, the BlockExecutor and the tx index live in
the submodules validation, execution and txindex."""

from .state import State, make_genesis_state, median_time
from .store import StateStore

__all__ = ["State", "StateStore", "make_genesis_state", "median_time"]
