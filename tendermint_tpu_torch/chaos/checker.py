"""Jepsen-flavor invariant checker for chaos runs (the port's copy of
tendermint_tpu/chaos/checker.py).

The checker is PURE bookkeeping: rigs feed it observations (per-node
heights and per-height block hashes, scraped from `/status`, `/blockchain`
and `/commit` on the process rig, or straight from block stores
in-process), and it accumulates violations.  Keeping it observation-driven
means the in-process tests and the multi-process rig (`chip_smoke.py` phase 17)
rig judge runs with the SAME code — one definition of "the net behaved".

Invariants:

  agreement      no two nodes ever commit different block hashes at one
                 height (the safety promise of arXiv:1807.04938 under
                 <= 1/3 byzantine power) — checked across every pair of
                 observations, live and historical
  no regression  a node's reported height never decreases (a restart of a
                 durable node resumes at or past its old height; a
                 memdb rig calls note_restart to re-arm the floor)
  liveness       after a heal/restart, commits resume within a bound
                 (RecoveryTimer measures the actual recovery, the rig
                 asserts the bound)
  accountability the twin's DuplicateVoteEvidence is committed into a
                 block and delivered via BeginBlock byzantine_validators
                 (scan helpers below; the kvstore app records delivery)

Nodes in `liveness_exempt` (the twin, which reference-correctly halts on
seeing its own conflict) are excluded from liveness expectations but NOT
from agreement — any block a byzantine node did commit must still match.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence


class InvariantViolation(AssertionError):
    pass


class InvariantChecker:
    def __init__(self, n_nodes: int, liveness_exempt: Sequence[int] = ()):
        self.n_nodes = n_nodes
        self.liveness_exempt = set(liveness_exempt)
        # height -> {node: block_hash}; hashes kept so late joiners /
        # restarted nodes are checked against history, not just the tip
        self.block_hashes: Dict[int, Dict[int, bytes]] = {}
        self.last_height: Dict[int, int] = {}
        self.violations: List[str] = []

    # -- observations ------------------------------------------------------

    def observe_height(self, node: int, height: Optional[int]) -> None:
        """`/status` latest_block_height; None / negative = unreachable
        (a down node is not a violation — liveness is the rig's timer)."""
        if height is None or height < 0:
            return
        prev = self.last_height.get(node)
        if prev is not None and height < prev:
            self._violate(
                f"height regression on node {node}: {prev} -> {height}"
            )
        self.last_height[node] = max(height, prev if prev is not None else height)

    def observe_block_hash(self, node: int, height: int, block_hash: bytes) -> None:
        """A block hash node reports at height (from `/blockchain` metas,
        `/commit`, or a block store).  Agreement is checked immediately
        against every other node's observation at that height."""
        if not block_hash:
            return
        seen = self.block_hashes.setdefault(height, {})
        for other, other_hash in seen.items():
            if other != node and other_hash != block_hash:
                self._violate(
                    f"AGREEMENT violated at height {height}: node {node} "
                    f"committed {block_hash.hex()[:16]}, node {other} "
                    f"committed {other_hash.hex()[:16]}"
                )
        prev = seen.get(node)
        if prev is not None and prev != block_hash:
            self._violate(
                f"node {node} rewrote its own height {height}: "
                f"{prev.hex()[:16]} -> {block_hash.hex()[:16]}"
            )
        seen[node] = block_hash

    def observe_served_block(
        self, node: int, height: int, claimed_hash: bytes, block_hash: bytes
    ) -> None:
        """A FULL block a node served (via `/block`, fastsync, or a store
        read) next to the identity it claims for it (its meta / commit
        hash at that height).  Serving content whose recomputed hash does
        not match the claim means the node handed out CORRUPTED data as a
        valid block — a violation, not a crash (the self-healing store's
        whole promise is answering "don't have it" instead).  The claimed
        hash also joins the regular agreement check."""
        if not claimed_hash or not block_hash:
            return
        if block_hash != claimed_hash:
            self._violate(
                f"node {node} SERVED a corrupted block at height {height}: "
                f"content {block_hash.hex()[:16]} != claimed {claimed_hash.hex()[:16]}"
            )
            return
        self.observe_block_hash(node, height, claimed_hash)

    def note_restart(self, node: int) -> None:
        """Re-arm the regression floor for a node whose rig legitimately
        wipes state on restart (memdb backends); its history observations
        still participate in agreement."""
        self.last_height.pop(node, None)

    def observe_node(self, idx: int, node) -> None:
        """In-process convenience: scrape a live Node's block store."""
        bs = node.block_store
        h = bs.height()
        self.observe_height(idx, h)
        for height in range(max(bs.base(), 1, h - 19), h + 1):
            meta = bs.load_block_meta(height)
            if meta is not None:
                self.observe_block_hash(idx, height, meta.block_id.hash)

    # -- verdicts ----------------------------------------------------------

    def _violate(self, msg: str) -> None:
        self.violations.append(msg)

    def agreed_heights(self) -> List[int]:
        """Heights at which >= 2 nodes were observed (i.e. agreement was
        actually CHECKED, not vacuously true)."""
        return sorted(h for h, seen in self.block_hashes.items() if len(seen) >= 2)

    def ok(self) -> bool:
        return not self.violations

    def raise_if_violated(self) -> None:
        if self.violations:
            raise InvariantViolation(
                f"{len(self.violations)} invariant violation(s):\n  "
                + "\n  ".join(self.violations)
            )

    def summary(self) -> dict:
        return {
            "nodes": self.n_nodes,
            "heights_checked": len(self.agreed_heights()),
            "max_height": max(self.last_height.values(), default=0),
            "violations": list(self.violations),
        }


class RecoveryTimer:
    """Measures commit-resumption after a fault clears: `mark(name,
    baseline)` when the heal/restart happens, then feed every subsequent
    liveness observation through `observe(height)` — the first height
    ABOVE the baseline closes the mark and records the recovery in ms.
    `recovery_ms` holds one number per mark; an unclosed mark means the
    net never recovered (the rig's bound assertion catches it)."""

    def __init__(self, now_fn=time.monotonic):
        self._now = now_fn
        self._open: Dict[str, tuple] = {}  # name -> (t0, baseline_height)
        self.recovery_ms: Dict[str, float] = {}

    def mark(self, name: str, baseline_height: int) -> None:
        self._open[name] = (self._now(), baseline_height)

    def observe(self, height: Optional[int]) -> None:
        if height is None or height < 0:
            return
        for name, (t0, baseline) in list(self._open.items()):
            if height > baseline:
                self.recovery_ms[name] = (self._now() - t0) * 1000.0
                del self._open[name]

    def unrecovered(self) -> List[str]:
        return sorted(self._open)


def scan_committed_evidence(block_store, max_back: int = 200) -> List[tuple]:
    """(height, evidence) pairs committed in the store's recent blocks —
    the accountability scan shared by the in-process test and (via RPC
    block fetches) the smoke rig's logic."""
    out = []
    tip = block_store.height()
    for h in range(max(block_store.base(), 1, tip - max_back), tip + 1):
        block = block_store.load_block(h)
        if block is not None and block.evidence:
            for ev in block.evidence:
                out.append((h, ev))
    return out
