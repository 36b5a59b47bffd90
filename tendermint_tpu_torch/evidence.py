"""Evidence pool: stores and validates misbehaviour evidence (the port's
copy of tendermint_tpu/evidence.py).

Reference parity: evidence/pool.go (Pool:18, AddEvidence:98, Update:76,
PendingEvidence:64, MarkEvidenceAsCommitted, IsCommitted) and
evidence/store.go key scheme.
"""

from __future__ import annotations

from typing import List

from .encoding import codec
from .libs.kvstore import KVStore
from .libs.log import get_logger
from .state.validation import verify_evidence
from .types.block import Block
from .types.evidence import Evidence


def _k_pending(height: int, ev_hash: bytes) -> bytes:
    return b"evp/%020d/" % height + ev_hash.hex().encode()


def _k_committed(ev_hash: bytes) -> bytes:
    return b"evc/" + ev_hash.hex().encode()


class EvidencePool:
    def __init__(self, db: KVStore, state_store, state=None):
        self.db = db
        self.state_store = state_store
        self.state = state  # updated via update()
        self.log = get_logger("evidence")
        # new-evidence callbacks (reactor gossip hook)
        self.on_evidence = []
        # observability (node swaps in prometheus + its FlightRecorder);
        # the pool used to be invisible — the accountability pipeline's
        # middle leg left no telemetry between detection and block
        from .libs import tracing
        from .libs.metrics import EvidenceMetrics

        self.metrics = EvidenceMetrics()
        self.recorder = tracing.NOP
        # pending count maintained incrementally (one scan at open, ±1 on
        # add/commit/prune) — the gauge must not cost a full prefix scan
        # per event on the commit path
        self._n_pending = sum(1 for _ in self.db.iterate_prefix(b"evp/"))

    def set_state(self, state) -> None:
        self.state = state

    # -- ingress -----------------------------------------------------------
    def add_evidence(self, ev: Evidence) -> None:
        """evidence/pool.go:98 — verify, dedup, persist, notify."""
        if self.is_committed(ev) or self.is_pending(ev):
            return
        if self.state is not None:
            verify_evidence(self.state, ev, self.state_store)
        self.db.set(_k_pending(ev.height(), ev.hash()), codec.dumps(ev))
        self.log.info("verified new evidence of byzantine behaviour", evidence=repr(ev))
        self.recorder.record(
            "evidence.add", height=ev.height(), hash=ev.hash().hex()[:16]
        )
        self._n_pending += 1
        self.metrics.pending.set(self._n_pending)
        for cb in self.on_evidence:
            cb(ev)

    def num_pending(self) -> int:
        return self._n_pending

    # -- queries -----------------------------------------------------------
    def pending_evidence(self, max_num: int = -1) -> List[Evidence]:
        """evidence/pool.go:64."""
        out = []
        for _, raw in self.db.iterate_prefix(b"evp/"):
            out.append(codec.loads(raw))
            if 0 <= max_num <= len(out):
                break
        return out

    def is_pending(self, ev: Evidence) -> bool:
        return self.db.has(_k_pending(ev.height(), ev.hash()))

    def is_committed(self, ev: Evidence) -> bool:
        return self.db.has(_k_committed(ev.hash()))

    # -- post-commit -------------------------------------------------------
    def update(self, block: Block, state) -> None:
        """evidence/pool.go:76 — mark block evidence committed, drop
        expired pending evidence."""
        self.state = state
        for ev in block.evidence:
            self.mark_committed(ev)
        self._prune_expired(state)

    def mark_committed(self, ev: Evidence) -> None:
        already = self.is_committed(ev)
        was_pending = self.is_pending(ev)
        self.db.write_batch(
            [(_k_committed(ev.hash()), b"1")],
            deletes=[_k_pending(ev.height(), ev.hash())],
        )
        if was_pending:
            self._n_pending -= 1
        if not already:
            self.metrics.committed.inc()
            self.recorder.record(
                "evidence.commit", height=ev.height(), hash=ev.hash().hex()[:16]
            )
        self.metrics.pending.set(self._n_pending)

    def _prune_expired(self, state) -> None:
        params = state.consensus_params.evidence
        deletes = []
        for key, raw in self.db.iterate_prefix(b"evp/"):
            ev = codec.loads(raw)
            too_old_blocks = state.last_block_height - ev.height() > params.max_age_num_blocks
            too_old_time = state.last_block_time_ns - ev.time_ns() > params.max_age_duration_ns
            if too_old_blocks and too_old_time:
                deletes.append(key)
        if deletes:
            self.db.write_batch([], deletes)
            self._n_pending -= len(deletes)
            self.metrics.pending.set(self._n_pending)


class NopEvidencePool:
    """state/services.go MockEvidencePool equivalent."""

    def add_evidence(self, ev) -> None:
        pass

    def pending_evidence(self, max_num: int = -1):
        return []

    def is_committed(self, ev) -> bool:
        return False

    def is_pending(self, ev) -> bool:
        return False

    def update(self, block, state) -> None:
        pass
