"""Witness-diversity rotation for the multi-tenant verification gateway (the
port's copy of tendermint_tpu/liteserve/witness.py; the same subsets for the
same seed).

A single-tenant lite2 client cross-checks every verification against ALL
of its witnesses, serially.  At gateway scale that is both too slow (every
verification pays W round-trips) and too predictable (an adversary that
controls the fixed witness set controls the cross-check).  The pool
instead rotates a seeded subset of size `quorum` per verification:

  - **rotation**: subset selection is a deterministic function of
    (seed, rotation counter), so runs are reproducible under test while
    successive verifications still spread across the pool — over time
    every witness participates, and no fixed coalition of `quorum`
    witnesses is always the one consulted;
  - **error scoring**: per-witness consecutive-error counts (fed by the
    lite2 client's demotion callback or directly via `report_error`)
    demote flaky/dark witnesses out of the active set — `promote()` then
    hands `replace_primary` an honest provider, never a dead one;
  - **re-probation**: demoted witnesses are retained (operators see them
    in lite_status) and can be re-armed explicitly via `restore()`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional

from ..libs.log import get_logger
from ..lite2.provider import Provider


@dataclass
class _Slot:
    provider: Provider
    addr: str = ""
    errors: int = 0
    demotions: int = 0
    consults: int = 0


@dataclass
class WitnessPool:
    seed: int = 0
    quorum: int = 2
    error_threshold: int = 3
    active: List[_Slot] = field(default_factory=list)
    demoted: List[_Slot] = field(default_factory=list)
    rotations: int = 0
    total_demotions: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self.log = get_logger("liteserve.witness")

    # -- membership --------------------------------------------------------

    def add(self, provider: Provider, addr: str = "") -> None:
        self.active.append(_Slot(provider, addr=addr))

    def providers(self) -> List[Provider]:
        return [s.provider for s in self.active]

    def size(self) -> int:
        return len(self.active)

    # -- rotation ----------------------------------------------------------

    def select(self, k: Optional[int] = None) -> List[Provider]:
        """The rotating subset for one verification: `k` (default quorum)
        active witnesses drawn by the seeded RNG.  Fewer than `k` active
        witnesses means all of them — diversity degrades before safety."""
        k = self.quorum if k is None else k
        self.rotations += 1
        if len(self.active) <= k:
            chosen = list(self.active)
        else:
            chosen = self._rng.sample(self.active, k)
        for s in chosen:
            s.consults += 1
        return [s.provider for s in chosen]

    # -- scoring -----------------------------------------------------------

    def _slot(self, provider: Provider) -> Optional[_Slot]:
        for s in self.active:
            if s.provider is provider:
                return s
        return None

    def report_ok(self, provider: Provider) -> None:
        s = self._slot(provider)
        if s is not None:
            s.errors = 0

    def report_error(self, provider: Provider) -> bool:
        """Score one error; returns True if this crossed the demotion
        threshold (and the witness left the active set)."""
        s = self._slot(provider)
        if s is None:
            return False
        s.errors += 1
        if s.errors < self.error_threshold:
            return False
        self.demote(provider, reason=f"{s.errors} consecutive errors")
        return True

    def demote(self, provider: Provider, reason: str = "") -> None:
        """Remove from the active set (idempotent).  Fed by the lite2
        client's on_witness_demoted callback and by the divergence
        majority check in the service."""
        s = self._slot(provider)
        if s is None:
            return
        self.active.remove(s)
        s.demotions += 1
        s.errors = 0
        self.demoted.append(s)
        self.total_demotions += 1
        self.log.info("witness demoted", addr=s.addr or type(provider).__name__,
                      reason=reason)

    def restore(self, provider: Provider) -> None:
        for s in list(self.demoted):
            if s.provider is provider:
                self.demoted.remove(s)
                self.active.append(s)
                return

    # -- promotion (primary replacement) -----------------------------------

    def promote(self) -> Provider:
        """Hand out the least-error active witness as the new primary; it
        leaves the witness pool (a primary must not witness itself)."""
        if not self.active:
            raise LookupError("witness pool exhausted: nothing to promote")
        s = min(self.active, key=lambda s: (s.errors, s.demotions))
        self.active.remove(s)
        self.log.info("promoted witness to primary", addr=s.addr or "")
        return s.provider

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "active": len(self.active),
            "demoted": len(self.demoted),
            "rotations": self.rotations,
            "demotions": self.total_demotions,
            "witnesses": [
                {"addr": s.addr, "errors": s.errors, "consults": s.consults,
                 "demoted": False}
                for s in self.active
            ] + [
                {"addr": s.addr, "errors": s.errors, "consults": s.consults,
                 "demoted": True}
                for s in self.demoted
            ],
        }
