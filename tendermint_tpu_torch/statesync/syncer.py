"""Statesync syncer: snapshot discovery → trust root → chunked restore (the
port's copy of tendermint_tpu/statesync/syncer.py: the same pipeline,
messages, exceptions, metrics and recorder events).

Reference parity: statesync/syncer.go (AddSnapshot, SyncAny, offer/apply
flow, verifyApp) restructured the repo way — the chunk FSM lives in
chunker.py, IO in reactor.py, and this file owns the bootstrap pipeline:

  1. collect peer snapshot advertisements for `discovery_time`, rank by
     (height, format, peer count);
  2. fetch the light blocks at the snapshot height H and H+1 through the
     lite2 client (bisection from the configured trust root), with every
     commit verification pre-batched through the node's shared
     AsyncBatchVerifier — one engine flush per commit (a flat batch: the
     ladder kernel), the same ingress consensus votes ride;
  3. OfferSnapshot to the app with the VERIFIED app hash (header H+1
     carries the app hash of the state after block H), then fetch +
     hash-verify + apply chunks in order;
  4. check the restored app (Info) against the verified header, persist
     state via StateStore.bootstrap and the header/commit via
     BlockStore.bootstrap_light_block, and hand the state to the fastsync
     tail.

A rejected/failed snapshot falls through to the next candidate; when all
candidates are exhausted the caller falls back to fastsync-from-genesis.

EngineCommitPreverify sends the ed25519 signatures of a commit to the
engine; sr25519, secp256k1 and multisig signers verify on the host in
mixed_batch_verify, as in the JAX package.  An aggregate (BLS) commit is
one pairing claim, run through the verifier's `verify_bls_aggregates` lane.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..abci import types as abci
from ..crypto import batch as crypto_batch
from ..crypto.keys import Ed25519PubKey
from ..libs.log import get_logger
from ..libs.metrics import StateSyncMetrics
from ..libs.tracing import NOP as NOP_RECORDER
from ..lite2 import BISECTION, Client as LightClient, TrustOptions
from ..lite2.provider import HTTPProvider, Provider
from ..state.state import State
from ..types.agg_commit import AggregateCommit
from ..types.block import SignedHeader
from ..types.validator import ValidatorSet
from .chunker import ChunkScheduler

log = get_logger("statesync")


class StateSyncError(Exception):
    """Statesync cannot proceed at all (trust failure, app abort)."""


class SnapshotRejectedError(Exception):
    """This snapshot is unusable; try the next candidate."""


class TrustRootUnavailableError(SnapshotRejectedError):
    """The light client could not verify this snapshot's height.  Usually
    a per-candidate problem (lying peer, height not yet served), but two
    in a row means the trust servers themselves are dark — give up and
    fall back rather than grind through every candidate."""


class EngineCommitPreverify:
    """lite2 `commit_preverify` hook: pre-verify a whole commit's ed25519
    signatures through the shared AsyncBatchVerifier as ONE arrival (=>
    one flush, one host-prep pass), then serve the synchronous
    verify_commit path from the result cache.  Cache misses fall back to
    the installed process-wide batch hook — still the device path, just
    not coalesced."""

    def __init__(self, async_verifier):
        self.async_verifier = async_verifier
        self._cache: Dict[Tuple[bytes, bytes, bytes], bool] = {}

    async def __call__(self, sh: SignedHeader, vals_sets: List[ValidatorSet]):
        vals = vals_sets[0]  # index-aligned set; other sets share pubkeys by address
        if isinstance(sh.commit, AggregateCommit):
            # ONE pairing claim for the whole commit, run on the engine's
            # flush executor; the scheme memo it warms serves the
            # synchronous verify_commit / verify_commit_trusting that follow
            if vals.size() != sh.commit.signers.bits:
                return None
            pks = [
                vals.validators[i].pub_key.bytes()
                for i in sh.commit.signers.true_indices()
            ]
            await self.async_verifier.verify_bls_aggregates(
                [(pks, sh.commit.sign_message(sh.header.chain_id), sh.commit.agg_sig)]
            )
            return None  # the sync path takes the aggregate branch and the memo
        if vals.size() != len(sh.commit.signatures):
            return None  # malformed; let verify_commit raise its own error
        items = []
        for idx, cs in enumerate(sh.commit.signatures):
            if cs.is_absent():
                continue
            pk = vals.validators[idx].pub_key
            if not isinstance(pk, Ed25519PubKey):
                continue  # non-ed25519 rides mixed_batch_verify's own path
            key = (pk.bytes(), sh.commit.vote_sign_bytes(sh.header.chain_id, idx), cs.signature)
            if key not in self._cache:
                items.append(key)
        if items:
            futs = self.async_verifier.verify_many(items)
            results = await asyncio.gather(*futs)
            self._cache.update(zip(items, (bool(r) for r in results)))
        return self._lookup

    def _lookup(self, pubkeys: List[bytes], msgs: List[bytes], sigs: List[bytes]) -> List[bool]:
        out: List[bool] = []
        miss: List[int] = []
        for i, key in enumerate(zip(pubkeys, msgs, sigs)):
            hit = self._cache.get(key)
            if hit is None:
                out.append(False)
                miss.append(i)
            else:
                out.append(hit)
        if miss:
            res = crypto_batch.get_verifier()(
                [pubkeys[i] for i in miss], [msgs[i] for i in miss], [sigs[i] for i in miss]
            )
            for i, r in zip(miss, res):
                out[i] = bool(r)
        return out


def _snapshot_key(s: abci.Snapshot) -> tuple:
    return (s.height, s.format, s.chunks, s.hash)


class StateSyncer:
    """Drives one node bootstrap.  The reactor feeds it snapshot offers,
    chunk responses and peer lifecycle; `run()` returns the restored State
    or None when every candidate failed."""

    def __init__(
        self,
        config,  # StateSyncConfig
        genesis_doc,
        state_store,
        block_store,
        proxy_app,
        async_verifier=None,
        metrics: Optional[StateSyncMetrics] = None,
        recorder=None,
        provider_factory: Optional[Callable[[], Tuple[Provider, List[Provider]]]] = None,
    ):
        self.config = config
        self.genesis_doc = genesis_doc
        self.chain_id = genesis_doc.chain_id
        self.state_store = state_store
        self.block_store = block_store
        self.proxy_app = proxy_app
        self.async_verifier = async_verifier
        self.metrics = metrics or StateSyncMetrics()
        self.recorder = recorder or NOP_RECORDER
        self.provider_factory = provider_factory or self._default_providers
        self.log = log

        # reactor-injected IO callbacks
        self.request_chunk = None  # async (peer_id, height, format, index) -> bool
        self.report_bad_peer = None  # async (peer_id, reason) -> None
        self.refresh_snapshots = None  # async () -> None: re-broadcast discovery

        self.wake = asyncio.Event()
        self.snapshots: Dict[tuple, dict] = {}  # key -> {"snapshot", "peers"}
        self.peers: Set[str] = set()
        self._rejected: Set[tuple] = set()
        self._current: Optional[abci.Snapshot] = None
        self._sched: Optional[ChunkScheduler] = None
        self.chunks_applied = 0
        self.chunks_total = 0

    # -- reactor-facing ----------------------------------------------------
    def add_peer(self, peer_id: str) -> None:
        self.peers.add(peer_id)
        if self._sched is not None and self._current is not None:
            # only ADVERTISERS of the in-flight snapshot serve chunks: a
            # non-haver answering `missing` would burn the chunk's retry
            # budget and reject a perfectly fetchable snapshot
            ent = self.snapshots.get(_snapshot_key(self._current))
            if ent is not None and peer_id in ent["peers"]:
                self._sched.add_peer(peer_id)
        self.wake.set()

    def remove_peer(self, peer_id: str) -> None:
        self.peers.discard(peer_id)
        for ent in self.snapshots.values():
            ent["peers"].discard(peer_id)
        if self._sched is not None:
            self._sched.remove_peer(peer_id)
        self.wake.set()

    # accumulation caps: advertisements carry up to ~2 MiB of metadata
    # each, so an unbounded dict is an attacker-paced allocation
    MAX_SNAPSHOTS_TOTAL = 128
    MAX_SNAPSHOTS_PER_PEER = 16

    def add_snapshot(self, peer_id: str, snap: abci.Snapshot) -> bool:
        """Record a peer's snapshot advertisement; True if new."""
        if snap.height < 1 or snap.chunks < 1 or snap.chunks > 16384:
            return False
        key = _snapshot_key(snap)
        ent = self.snapshots.get(key)
        if ent is None:
            if len(self.snapshots) >= self.MAX_SNAPSHOTS_TOTAL:
                return False
            advertised = sum(
                1 for e in self.snapshots.values() if peer_id in e["peers"]
            )
            if advertised >= self.MAX_SNAPSHOTS_PER_PEER:
                return False
            ent = self.snapshots[key] = {"snapshot": snap, "peers": set()}
            self.metrics.snapshots_discovered.inc()
            new = True
        else:
            new = False
        ent["peers"].add(peer_id)
        # a live advertiser of the snapshot currently being restored can
        # serve its chunks from now on
        if (
            self._sched is not None
            and self._current is not None
            and key == _snapshot_key(self._current)
            and peer_id in self.peers
        ):
            self._sched.add_peer(peer_id)
        self.wake.set()
        return new

    def on_chunk(
        self, peer_id: str, height: int, format_: int, index: int, chunk: bytes, missing: bool
    ) -> None:
        sched, snap = self._sched, self._current
        if sched is None or snap is None or (height, format_) != (snap.height, snap.format):
            return
        now = time.monotonic()
        if missing:
            sched.chunk_missing(peer_id, index, now)
        else:
            verdict = sched.chunk_received(peer_id, index, chunk, now)
            if verdict == "ok":
                self.metrics.chunks_fetched.inc()
            elif verdict == "bad_hash":
                self.metrics.chunks_failed.inc()
                self.metrics.chunks_refetched.inc()
                self._spawn_report(peer_id, f"bad snapshot chunk {index} (hash mismatch)")
        self.wake.set()

    def _spawn_report(self, peer_id: str, reason: str) -> None:
        if self.report_bad_peer is not None:
            asyncio.ensure_future(self.report_bad_peer(peer_id, reason))

    @property
    def progress(self) -> Tuple[int, int]:
        return self.chunks_applied, self.chunks_total

    # -- pipeline ----------------------------------------------------------
    async def run(self) -> Optional[State]:
        """Discovery → best-snapshot restore loop.  Returns the restored
        state, or None when statesync cannot complete (caller falls back
        to fastsync)."""
        await self._discover()
        tried = 0
        rediscoveries = 0
        trust_failures = 0
        while True:
            candidate = self._best_snapshot()
            if candidate is None:
                # peers may simply have connected after the discovery
                # window (or all candidates went stale): re-broadcast a
                # bounded number of times before giving up
                if rediscoveries < 3:
                    rediscoveries += 1
                    if self.refresh_snapshots is not None:
                        await self.refresh_snapshots()
                    await self._wait_wake(max(0.5, self.config.discovery_time))
                    continue
                if tried == 0:
                    self.log.info("statesync: no snapshots discovered")
                return None
            snap, peers = candidate
            tried += 1
            try:
                return await self._restore(snap, peers)
            except SnapshotRejectedError as e:
                self.log.info(
                    "statesync: snapshot rejected",
                    height=snap.height, format=snap.format, reason=str(e),
                )
                self._rejected.add(_snapshot_key(snap))
                self._current, self._sched = None, None
                if isinstance(e, TrustRootUnavailableError):
                    trust_failures += 1
                    if trust_failures >= 2:
                        # two candidates unverifiable in a row: the trust
                        # servers are dark, not the snapshots — without a
                        # cap the re-discovery loop would grind forever
                        self.log.error("statesync: trust servers unreachable, giving up")
                        return None
                else:
                    trust_failures = 0
                # the chain moved on while we tried: ask peers for FRESH
                # snapshots before falling back to an even staler candidate
                if self.refresh_snapshots is not None:
                    await self.refresh_snapshots()
                    await self._wait_wake(1.0)
            except StateSyncError as e:
                self.log.error("statesync aborted", err=str(e))
                return None

    async def _discover(self) -> None:
        deadline = time.monotonic() + max(0.0, self.config.discovery_time)
        while time.monotonic() < deadline:
            await self._wait_wake(min(0.25, max(0.01, deadline - time.monotonic())))
        self.log.info(
            "statesync: discovery complete",
            snapshots=len(self.snapshots), peers=len(self.peers),
        )

    async def _wait_wake(self, timeout: float) -> None:
        from ..libs.service import wait_event

        await wait_event(self.wake, timeout)
        self.wake.clear()

    def _best_snapshot(self) -> Optional[Tuple[abci.Snapshot, Set[str]]]:
        alive = [
            (ent["snapshot"], ent["peers"] & self.peers)
            for key, ent in self.snapshots.items()
            if key not in self._rejected and (ent["peers"] & self.peers)
        ]
        if not alive:
            return None
        alive.sort(key=lambda sp: (sp[0].height, sp[0].format, len(sp[1])), reverse=True)
        return alive[0]

    # -- trust root --------------------------------------------------------
    def _default_providers(self) -> Tuple[Provider, List[Provider]]:
        servers = [s.strip() for s in self.config.rpc_servers.split(",") if s.strip()]
        if not servers:
            raise StateSyncError("statesync.rpc_servers is empty")
        providers = [HTTPProvider(self.chain_id, addr) for addr in servers]
        return providers[0], providers[1:]

    async def _trust_root(self, height: int):
        """lite2-verified headers at H and H+1 plus the validator sets at
        H, H+1 and H+2 — everything a bootstrapped State needs."""
        trust_hash = self.config.trust_hash
        if isinstance(trust_hash, str):
            trust_hash = bytes.fromhex(trust_hash)
        if self.config.trust_height < 1 or len(trust_hash) != 32:
            raise StateSyncError("statesync requires trust_height and a 32-byte trust_hash")
        primary, witnesses = self.provider_factory()
        try:
            # reachability/plausibility split: if the primary cannot even
            # serve its LATEST header, the trust servers are dark (counts
            # toward the give-up cap); if it can, but the candidate height
            # is beyond the chain tip, the candidate is bogus (a lying
            # peer — an honest snapshot is always at a committed height)
            # and only that candidate is rejected.  H+1/H+2 merely not yet
            # at the tip is NOT bogus: the chain produces them within the
            # caller's retry window.
            latest = await primary.signed_header(0)
            if height > latest.height:
                raise SnapshotRejectedError(
                    f"snapshot height {height} beyond chain tip {latest.height}"
                )
            preverify = (
                EngineCommitPreverify(self.async_verifier)
                if self.async_verifier is not None
                else None
            )
            client = LightClient(
                self.chain_id,
                TrustOptions(
                    period_ns=int(self.config.trust_period * 1e9),
                    height=self.config.trust_height,
                    hash=trust_hash,
                ),
                primary,
                witnesses=witnesses,
                mode=BISECTION,
                commit_preverify=preverify,
            )
            lb_h = await client.verify_header_at_height(height)
            lb_h1 = await client.verify_header_at_height(height + 1)
            vals_h = client.store.validator_set(height)
            vals_h1 = client.store.validator_set(height + 1)
            # the set for H+2 is committed to by header H+1; fetch + hash-check
            vals_h2 = await primary.validator_set(height + 2)
            if vals_h2.hash() != lb_h1.header.next_validators_hash:
                raise StateSyncError(
                    f"validator set at {height + 2} does not match header "
                    f"{height + 1}'s next_validators_hash"
                )
            params = await self._consensus_params(primary, height + 1, lb_h1)
            return lb_h, lb_h1, vals_h, vals_h1, vals_h2, params
        finally:
            for p in (primary, *witnesses):
                close = getattr(p, "close", None)
                if close is not None:
                    await close()

    async def _consensus_params(self, primary: Provider, height: int, lb_h1):
        """Consensus params active at H+1, hash-checked against the
        verified header's consensus_hash; genesis params as fallback for
        chains that never changed them."""
        from ..types.params import ConsensusParams

        params = None
        client = getattr(primary, "client", None)
        if client is not None:
            try:
                res = await client.consensus_params(height)
                if res.get("consensus_params"):
                    params = ConsensusParams.from_dict(res["consensus_params"])
            except Exception as e:
                self.log.info("statesync: consensus_params fetch failed", err=str(e))
        if params is None:
            params = self.genesis_doc.consensus_params
        if params.hash() != lb_h1.header.consensus_hash:
            raise StateSyncError(
                f"consensus params at {height} do not match header consensus_hash"
            )
        return params

    # -- restore -----------------------------------------------------------
    async def _restore(self, snap: abci.Snapshot, peers: Set[str]) -> State:
        from ..encoding import codec

        height = snap.height
        self.log.info(
            "statesync: restoring snapshot",
            height=height, format=snap.format, chunks=snap.chunks, peers=len(peers),
        )
        # chunk hashes ride the snapshot metadata (the kvstore app format);
        # the syncer verifies every chunk against them BEFORE the app sees
        # it, so a lying peer cannot even reach ApplySnapshotChunk
        try:
            hashes = codec.loads(snap.metadata)["chunk_hashes"]
            assert isinstance(hashes, list) and len(hashes) == snap.chunks
            assert all(isinstance(h, bytes) and len(h) == 32 for h in hashes)
        except Exception:
            raise SnapshotRejectedError("snapshot metadata lacks a valid chunk-hash list")

        t0 = time.monotonic()
        # the chain keeps moving while we sync: H+1/H+2 may be seconds away
        # from existing on the trust servers — bounded retries, then abort
        # (dead trust servers mean NO snapshot can verify; fall back)
        from ..lite2.provider import ProviderError

        for attempt in range(5):
            try:
                lb_h, lb_h1, vals_h, vals_h1, vals_h2, params = await self._trust_root(height)
                break
            except ProviderError as e:
                if attempt == 4:
                    # per-CANDIDATE failure: a lying peer advertising an
                    # unverifiable height (e.g. 10**9) must not abort the
                    # whole statesync — reject it and try the next one
                    raise TrustRootUnavailableError(f"trust root unavailable: {e}")
                await asyncio.sleep(0.3 * (attempt + 1))
        if lb_h1.header.app_hash == b"":
            raise SnapshotRejectedError("verified header has empty app hash")

        conn = self.proxy_app.query()
        res = await conn.offer_snapshot(
            abci.RequestOfferSnapshot(snapshot=snap, app_hash=lb_h1.header.app_hash)
        )
        self.metrics.snapshots_offered.inc()
        self.recorder.record(
            "statesync.offer", height=height, format=snap.format,
            chunks=snap.chunks, result=res.result,
        )
        R = abci.OfferSnapshotResult
        if res.result == R.ABORT:
            raise StateSyncError("app aborted snapshot restoration")
        if res.result != R.ACCEPT:
            raise SnapshotRejectedError(f"app rejected snapshot (result {res.result})")

        sched = ChunkScheduler(
            hashes,
            timeout=self.config.chunk_fetch_timeout,
            max_retries=self.config.chunk_fetch_retries,
        )
        self._current, self._sched = snap, sched
        self.chunks_applied, self.chunks_total = 0, snap.chunks
        for p in peers:
            sched.add_peer(p)

        try:
            await self._fetch_and_apply(snap, sched, conn)
        finally:
            self._current, self._sched = None, None

        # the app must now BE the snapshot — check against the verified header
        info = await conn.info(abci.RequestInfo(version="statesync"))
        if info.last_block_height != height:
            raise SnapshotRejectedError(
                f"restored app at height {info.last_block_height}, expected {height}"
            )
        if info.last_block_app_hash != lb_h1.header.app_hash:
            raise SnapshotRejectedError("restored app hash does not match verified header")

        state = State(
            chain_id=self.chain_id,
            version_block=lb_h1.header.version_block,
            version_app=lb_h1.header.version_app,
            last_block_height=height,
            last_block_id=lb_h1.header.last_block_id,
            last_block_time_ns=lb_h.header.time_ns,
            next_validators=vals_h2,
            validators=vals_h1,
            last_validators=vals_h,
            last_height_validators_changed=height + 1,
            consensus_params=params,
            last_height_consensus_params_changed=height + 1,
            last_results_hash=lb_h1.header.last_results_hash,
            app_hash=lb_h1.header.app_hash,
        )
        self.state_store.bootstrap(state)
        self.block_store.bootstrap_light_block(
            lb_h.header, lb_h.commit.block_id, lb_h.commit
        )
        restore_s = time.monotonic() - t0
        self.metrics.restore_duration_seconds.observe(restore_s)
        self.recorder.record(
            "statesync.restore", height=height, ms=round(restore_s * 1e3, 3)
        )
        self.log.info(
            "statesync: snapshot restored",
            height=height, chunks=snap.chunks, seconds=round(restore_s, 3),
        )
        return state

    async def _fetch_and_apply(self, snap, sched: ChunkScheduler, conn) -> None:
        A = abci.ApplySnapshotChunkResult
        while not sched.done():
            now = time.monotonic()
            for peer_id, idx in sched.next_requests(now):
                ok = True
                if self.request_chunk is not None:
                    ok = await self.request_chunk(peer_id, snap.height, snap.format, idx)
                if ok:
                    sched.mark_requested(peer_id, idx, now)
                else:
                    sched.remove_peer(peer_id)
            # apply every in-order chunk that is ready
            item = sched.next_apply()
            while item is not None:
                idx, chunk, sender = item
                res = await conn.apply_snapshot_chunk(
                    abci.RequestApplySnapshotChunk(index=idx, chunk=chunk, sender=sender)
                )
                for pid in res.reject_senders:
                    sched.ban_peer(pid)
                    self._spawn_report(pid, "app rejected snapshot chunk sender")
                if res.result == A.ACCEPT:
                    sched.mark_applied(idx)
                    self.chunks_applied = idx + 1
                    self.recorder.record(
                        "statesync.chunk", index=idx, total=snap.chunks, peer=sender
                    )
                elif res.result == A.RETRY:
                    self.metrics.chunks_refetched.inc()
                    for r in res.refetch_chunks or [idx]:
                        sched.refetch(r, time.monotonic(), avoid_peer=sender)
                elif res.result == A.RETRY_SNAPSHOT:
                    raise SnapshotRejectedError("app asked to restart the snapshot")
                elif res.result == A.ABORT:
                    raise StateSyncError("app aborted during chunk apply")
                else:
                    raise SnapshotRejectedError(f"app rejected chunk (result {res.result})")
                item = sched.next_apply()
            if sched.done():
                return
            if sched.is_failed():
                raise SnapshotRejectedError("chunk fetch failed (retries exhausted or no peers)")
            await self._wait_wake(0.25)
