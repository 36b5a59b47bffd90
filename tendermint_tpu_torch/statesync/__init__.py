"""State sync: bootstrap a fresh node from a peer-served app snapshot (the
port's copy of tendermint_tpu/statesync).

The subsystem that turns the two trust machines — the lite2
skipping-verification light client and the batch-verify engine on the
card — into a bootstrap path: instead of replaying every block from
genesis, a joining node restores a chunked application snapshot whose app
hash is checked against a lite2-verified header (commits batch-verified
through the shared engine), then fastsyncs only the tail.
"""

from .chunker import ChunkScheduler  # noqa: F401
from .reactor import CHUNK_CHANNEL, SNAPSHOT_CHANNEL, StateSyncReactor  # noqa: F401
from .syncer import (  # noqa: F401
    EngineCommitPreverify,
    SnapshotRejectedError,
    StateSyncError,
    StateSyncer,
)
