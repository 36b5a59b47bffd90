"""Stateful light client: the port's copy of tendermint_tpu/lite2/client.py.

Reference parity: lite2/client.go — Client:116, TrustOptions
(trust_options.go), initialization against the primary:368, sequence:621 /
bisection:688 / backwards:884 verification, witness cross-checking
compareNewHeaderWithWitnesses:932, primary replacement
replaceProvider:1037, pruning via max_retained_headers, expiry checks.

Every header acceptance costs one or two whole-commit batch
verifications on the card — the serial per-signature loop of
types/validator_set.go:641-668 never runs here.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..libs.log import get_logger
from ..types.block import SignedHeader
from ..types.validator import ValidatorSet
from .provider import Provider, ProviderError
from .store import LightStore, MemStore
from .verifier import (
    DEFAULT_TRUST_LEVEL,
    ErrNewValSetCantBeTrusted,
    InvalidHeaderError,
    header_expired,
    verify_adjacent,
    verify_non_adjacent,
)

SEQUENCE = "sequence"
BISECTION = "bisection"

_DEFAULT_MAX_CLOCK_DRIFT_NS = 10 * 1_000_000_000  # lite2/client.go defaultMaxClockDrift


class LightClientError(Exception):
    pass


class DivergedHeaderError(LightClientError):
    """A witness served a conflicting header for the same height — possible
    fork or lying primary (lite2/client.go:958)."""

    def __init__(self, height: int, witness_idx: int):
        super().__init__(f"witness #{witness_idx} diverged at height {height}")
        self.height = height
        self.witness_idx = witness_idx


@dataclass
class TrustOptions:
    """lite2/trust_options.go — the subjective-security root."""

    period_ns: int
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period_ns <= 0:
            raise ValueError("trusting period must be > 0")
        if self.height <= 0:
            raise ValueError("trust height must be > 0")
        if len(self.hash) != 32:
            raise ValueError(f"trust hash must be 32 bytes, got {len(self.hash)}")


class Client:
    """lite2/client.go:116."""

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: Sequence[Provider] = (),
        store: Optional[LightStore] = None,
        mode: str = BISECTION,
        trust_level: tuple = DEFAULT_TRUST_LEVEL,
        max_clock_drift_ns: int = _DEFAULT_MAX_CLOCK_DRIFT_NS,
        max_retained_headers: int = 0,
        now_fn=time.time_ns,
        commit_preverify=None,
        witness_timeout_s: float = 5.0,
        witness_error_threshold: int = 3,
        on_witness_demoted=None,
    ):
        """`commit_preverify` is an optional async hook
        `(signed_header, [validator_sets]) -> batch_verify | None` invoked
        before each commit verification.  Statesync passes an adapter that
        pre-verifies the whole commit through the node's shared
        AsyncBatchVerifier (one engine flush per commit — the same ingress
        consensus votes ride) and returns a cache-lookup batch_verify for
        the synchronous verify_commit path."""
        if mode not in (SEQUENCE, BISECTION):
            raise ValueError(f"unknown verification mode {mode!r}")
        trust_options.validate()
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses: List[Provider] = list(witnesses)
        self.store = store or MemStore()
        self.mode = mode
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.max_retained_headers = max_retained_headers
        self.now_fn = now_fn
        self.commit_preverify = commit_preverify
        # -- witness health: a witness that errors repeatedly (hung, dark,
        # or garbage) is DEMOTED out of the active pool instead of being
        # silently skipped forever — replace_primary must promote from an
        # honest pool, and a dead witness shields nothing.
        self.witness_timeout_s = witness_timeout_s
        self.witness_error_threshold = witness_error_threshold
        self.demoted_witnesses: List[Provider] = []
        self.on_witness_demoted = on_witness_demoted
        self._witness_errors: Dict[int, int] = {}  # id(provider) -> consecutive errors
        self.log = get_logger("lite2")
        self._initialized = False

    async def _bv(self, sh: SignedHeader, vals_sets):
        """Resolve the batch_verify callable for one commit verification."""
        if self.commit_preverify is None:
            return None
        return await self.commit_preverify(sh, vals_sets)

    # -- initialization ----------------------------------------------------

    async def initialize(self) -> None:
        """lite2/client.go:368 initializeWithTrustOptions: fetch the header
        at the trust height from the primary, check it against the trusted
        hash, check +2/3 of its own validators signed it."""
        if self._initialized:
            return
        existing = self.store.latest()
        if existing is not None:
            sh, _ = existing
            if not header_expired(sh, self.trust_options.period_ns, self.now_fn()):
                self._initialized = True
                return
        sh = await self.primary.signed_header(self.trust_options.height)
        if sh.header.hash() != self.trust_options.hash:
            raise LightClientError(
                f"expected header's hash {self.trust_options.hash.hex()}, "
                f"but got {sh.header.hash().hex()}"
            )
        vals = await self.primary.validator_set(self.trust_options.height)
        if sh.header.validators_hash != vals.hash():
            raise LightClientError("expected header's validators to match those supplied")
        # self-consistency: +2/3 of its own set signed it (client.go:403)
        vals.verify_commit(
            self.chain_id,
            sh.commit.block_id,
            sh.height,
            sh.commit,
            batch_verify=await self._bv(sh, [vals]),
        )
        self.store.save_signed_header_and_validator_set(sh, vals)
        self._initialized = True

    # -- public API --------------------------------------------------------

    async def trusted_header(self, height: int = 0) -> Optional[SignedHeader]:
        """lite2/client.go:449 TrustedHeader (0 = latest)."""
        if height == 0:
            height = self.store.latest_height()
        return self.store.signed_header(height)

    async def update(self, now_ns: Optional[int] = None) -> Optional[SignedHeader]:
        """lite2/client.go:524 — advance to the primary's latest header."""
        latest = await self.primary.signed_header(0)
        trusted_h = self.store.latest_height()
        if trusted_h and latest.height <= trusted_h:
            return None
        return await self.verify_header_at_height(latest.height, now_ns)

    async def verify_header_at_height(
        self, height: int, now_ns: Optional[int] = None
    ) -> SignedHeader:
        """lite2/client.go:481 VerifyHeaderAtHeight."""
        await self.initialize()
        now = now_ns if now_ns is not None else self.now_fn()
        existing = self.store.signed_header(height)
        if existing is not None:
            return existing
        latest_trusted_h = self.store.latest_height()
        # Track exactly what THIS pass persisted: if a witness reveals a
        # lying primary, every header the pass added must be rolled back —
        # the reference only keeps state that survived witness comparison
        # (client.go:505-512); serving poisoned headers from the store on
        # later calls would defeat the cross-check entirely.  A pass-local
        # set (not a before-snapshot of the whole store) keeps concurrent
        # passes isolated: the loser's rollback must not delete headers a
        # concurrent winner legitimately persisted in the meantime.
        saved: Set[int] = set()
        try:
            if height < self.store.first_height():
                sh = await self._backwards(height, now, saved)
            elif height <= latest_trusted_h:
                sh = await self._backwards(height, now, saved)
            elif self.mode == SEQUENCE:
                sh = await self._sequence(height, now, saved)
            else:
                sh = await self._bisection(height, now, saved)
            await self._compare_with_witnesses(sh)
        except DivergedHeaderError:
            # a strategy-phase divergence (backwards hash-chain break) rolls
            # back exactly like a witness-phase one: nothing a lying primary
            # served this pass may survive in the store
            for h in saved:
                self.store.delete(h)
            raise
        self._prune()
        return sh

    def _persist(self, sh: SignedHeader, vals: ValidatorSet, saved: Optional[Set[int]]) -> None:
        """Save a verified pair, recording the height in the pass-local
        `saved` set ONLY if this pass actually inserted it (a height that
        was already present belongs to whichever pass put it there)."""
        if saved is not None and self.store.signed_header(sh.height) is None:
            saved.add(sh.height)
        self.store.save_signed_header_and_validator_set(sh, vals)

    async def verify_header(self, sh: SignedHeader, vals: ValidatorSet, now_ns=None) -> None:
        """Verify a caller-supplied header (client.go:585 VerifyHeader)."""
        await self.initialize()
        now = now_ns if now_ns is not None else self.now_fn()
        trusted = self.store.latest()
        if trusted is None:
            raise LightClientError("no trusted state")
        t_sh, t_vals = trusted
        if sh.height <= t_sh.height:
            existing = self.store.signed_header(sh.height)
            if existing is not None and existing.header.hash() != sh.header.hash():
                raise DivergedHeaderError(sh.height, -1)
            if existing is not None:
                return
            raise LightClientError(f"header at height {sh.height} below trusted, not stored")
        if sh.height == t_sh.height + 1:
            verify_adjacent(
                self.chain_id, t_sh, sh, vals,
                self.trust_options.period_ns, now, self.max_clock_drift_ns,
                batch_verify=await self._bv(sh, [vals]),
            )
        else:
            verify_non_adjacent(
                self.chain_id, t_sh, t_vals, sh, vals,
                self.trust_options.period_ns, now, self.max_clock_drift_ns, self.trust_level,
                batch_verify=await self._bv(sh, [vals, t_vals]),
            )
        # witness cross-check BEFORE persisting: a diverged header must
        # never enter the trusted store (client.go:606-612)
        await self._compare_with_witnesses(sh)
        self.store.save_signed_header_and_validator_set(sh, vals)
        self._prune()

    # -- verification strategies ------------------------------------------

    async def _sequence(self, height: int, now: int, saved: Optional[Set[int]] = None) -> SignedHeader:
        """lite2/client.go:621 — verify every header one by one."""
        trusted_sh = self.store.signed_header(self.store.latest_height())
        for h in range(trusted_sh.height + 1, height + 1):
            sh = await self.primary.signed_header(h)
            vals = await self.primary.validator_set(h)
            verify_adjacent(
                self.chain_id, trusted_sh, sh, vals,
                self.trust_options.period_ns, now, self.max_clock_drift_ns,
                batch_verify=await self._bv(sh, [vals]),
            )
            self._persist(sh, vals, saved)
            trusted_sh = sh
        return trusted_sh

    async def _bisection(self, height: int, now: int, saved: Optional[Set[int]] = None) -> SignedHeader:
        """lite2/client.go:688 — skipping verification with binary descent:
        try to jump straight to the target on trust-level power; if the
        trusted set's power at the target is insufficient, bisect."""
        t_h = self.store.latest_height()
        trusted_sh = self.store.signed_header(t_h)
        trusted_vals = self.store.validator_set(t_h)

        # Per-pass fetch memo: the descent revisits the same pivots as the
        # trusted base advances (and always snaps back to the target), so
        # without this a byzantine primary that forces a deep descent buys
        # O(heights × retries) redundant round-trips for the same data.
        fetched: Dict[int, Tuple[SignedHeader, ValidatorSet]] = {}

        async def fetch(h: int) -> Tuple[SignedHeader, ValidatorSet]:
            pair = fetched.get(h)
            if pair is None:
                pair = (
                    await self.primary.signed_header(h),
                    await self.primary.validator_set(h),
                )
                fetched[h] = pair
            return pair

        target_sh, target_vals = await fetch(height)
        untrusted_sh, untrusted_vals = target_sh, target_vals

        for _ in range(1000):  # loop guard vs a byzantine primary
            if untrusted_sh.height == trusted_sh.height + 1:
                verify_adjacent(
                    self.chain_id, trusted_sh, untrusted_sh, untrusted_vals,
                    self.trust_options.period_ns, now, self.max_clock_drift_ns,
                    batch_verify=await self._bv(untrusted_sh, [untrusted_vals]),
                )
                verified = True
            else:
                try:
                    verify_non_adjacent(
                        self.chain_id, trusted_sh, trusted_vals, untrusted_sh, untrusted_vals,
                        self.trust_options.period_ns, now, self.max_clock_drift_ns,
                        self.trust_level,
                        batch_verify=await self._bv(untrusted_sh, [untrusted_vals, trusted_vals]),
                    )
                    verified = True
                except ErrNewValSetCantBeTrusted:
                    verified = False
            if verified:
                self._persist(untrusted_sh, untrusted_vals, saved)
                trusted_sh, trusted_vals = untrusted_sh, untrusted_vals
                if untrusted_sh.height == height:
                    return untrusted_sh
                untrusted_sh, untrusted_vals = target_sh, target_vals
            else:
                pivot = (trusted_sh.height + untrusted_sh.height) // 2
                if pivot == trusted_sh.height:
                    raise LightClientError("bisection cannot make progress")
                untrusted_sh, untrusted_vals = await fetch(pivot)
        raise LightClientError("bisection exceeded iteration bound")

    async def _backwards(self, height: int, now: int, saved: Optional[Set[int]] = None) -> SignedHeader:
        """lite2/client.go:884 — walk the LastBlockID hash-chain down from
        the closest trusted header above `height`."""
        above = None
        for h in self.store.heights():  # descending
            if h >= height:
                above = h
            else:
                break
        if above is None:
            raise LightClientError(f"no trusted header above height {height}")
        cur = self.store.signed_header(above)
        if header_expired(cur, self.trust_options.period_ns, now):
            raise InvalidHeaderError("closest trusted header expired")
        while cur.height > height:
            sh = await self.primary.signed_header(cur.height - 1)
            if sh.header.hash() != cur.header.last_block_id.hash:
                # the primary contradicts the already-trusted chain: that is
                # a divergence (witness_idx -1 = caught without a witness),
                # so callers route it through the same demote-the-primary
                # recovery as a witness-detected fork
                raise DivergedHeaderError(sh.height, -1)
            vals = await self.primary.validator_set(sh.height)
            if sh.header.validators_hash != vals.hash():
                raise LightClientError("validators don't match header at backwards step")
            self._persist(sh, vals, saved)
            cur = sh
        return cur

    # -- witness cross-check + primary replacement ------------------------

    async def _compare_with_witnesses(self, sh: SignedHeader) -> None:
        """lite2/client.go:932 compareNewHeaderWithWitnesses — all
        witnesses are queried CONCURRENTLY with a per-witness timeout, so
        one hung witness delays a verification by at most
        `witness_timeout_s` instead of stalling every other cross-check
        behind it.  Errors are scored per witness; `witness_error_threshold`
        consecutive failures demote the witness out of the active pool."""
        witnesses = list(self.witnesses)
        if not witnesses:
            return

        async def ask(w: Provider):
            return await asyncio.wait_for(
                w.signed_header(sh.height), timeout=self.witness_timeout_s
            )

        results = await asyncio.gather(*(ask(w) for w in witnesses), return_exceptions=True)
        diverged: Optional[int] = None
        for i, res in enumerate(results):
            w = witnesses[i]
            if isinstance(res, (ProviderError, asyncio.TimeoutError)):
                # witness lagging is not evidence of a fork — but it IS
                # evidence of a bad witness once it keeps happening
                self._note_witness_error(w, res)
                continue
            if isinstance(res, BaseException):
                raise res
            self._witness_errors.pop(id(w), None)
            if res.header.hash() != sh.header.hash():
                if diverged is None:
                    diverged = i
        if diverged is not None:
            raise DivergedHeaderError(sh.height, diverged)

    def _note_witness_error(self, w: Provider, err: BaseException) -> None:
        n = self._witness_errors.get(id(w), 0) + 1
        self._witness_errors[id(w)] = n
        if n < self.witness_error_threshold:
            return
        # demote: out of the active pool (so replace_primary never promotes
        # a dead provider), kept on the demoted list for the operator
        try:
            self.witnesses.remove(w)
        except ValueError:
            pass
        self.demoted_witnesses.append(w)
        self._witness_errors.pop(id(w), None)
        self.log.info(
            "demoted witness", witness=type(w).__name__, errors=n, last_err=repr(err)
        )
        if self.on_witness_demoted is not None:
            self.on_witness_demoted(w)

    async def replace_primary(self) -> None:
        """lite2/client.go:1037 replaceProvider: promote the first ACTIVE
        witness (demoted ones are no longer in the pool)."""
        if not self.witnesses:
            raise LightClientError("no witnesses left to replace the primary with")
        self.primary = self.witnesses.pop(0)
        self.log.info("replaced primary", new_primary=type(self.primary).__name__)

    # -- maintenance -------------------------------------------------------

    def _prune(self) -> None:
        if self.max_retained_headers <= 0:
            return
        hs = self.store.heights()
        for h in hs[self.max_retained_headers:]:
            self.store.delete(h)

    async def cleanup(self) -> None:
        """lite2/client.go Cleanup: forget all trusted state."""
        for h in self.store.heights():
            self.store.delete(h)
        self._initialized = False
