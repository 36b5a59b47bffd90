"""State sync's light-client lane: commits pre-verified through the shared
AsyncBatchVerifier (the port's part of tendermint_tpu/statesync)."""

from .syncer import EngineCommitPreverify  # noqa: F401
