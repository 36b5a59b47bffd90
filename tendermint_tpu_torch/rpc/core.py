"""RPC core handlers: the route table reading node internals (the port's
copy of tendermint_tpu/rpc/core.py: the same routes, parameters, results,
error codes and messages).

The chaos routes (`unsafe_chaos_*`) are gated as in JAX: `[chaos] enabled`
and `rpc.unsafe`.

Reference parity: rpc/core/routes.go:10-56 (route table),
rpc/core/status.go, blocks.go, mempool.go (BroadcastTxCommit:56),
abci.go, consensus.go, net.go, tx.go, events.go (subscribe),
evidence.go.  Handlers are async methods on RPCCore; the server (HTTP/WS)
and the in-proc LocalClient both dispatch through `call()`.
"""

from __future__ import annotations

import asyncio
import collections
import os
import time
from typing import Any, Dict, Optional

from ..abci.types import RequestInfo, RequestQuery
from ..libs.flowrate import TokenBucket
from ..libs.log import get_logger
from ..mempool import MempoolFullError
from ..types.events import EVENT_TX, EVENT_TYPE_KEY, TX_HASH_KEY
from ..types.tx import tx_hash
from .jsonrpc import (
    INTERNAL_ERROR,
    INVALID_PARAMS,
    METHOD_NOT_FOUND,
    RPCError,
    overloaded_error,
)

_MAX_PER_PAGE = 100


def _paginate(total: int, page: int, per_page: int) -> tuple[int, int]:
    """rpc/core/env.go validatePage/validatePerPage."""
    per_page = max(1, min(per_page, _MAX_PER_PAGE))
    pages = max(1, (total + per_page - 1) // per_page)
    if page < 1 or page > pages:
        raise RPCError(INVALID_PARAMS, f"page should be within [1, {pages}] range, given {page}")
    skip = (page - 1) * per_page
    return skip, min(skip + per_page, total)


class RPCCore:
    """Handlers bound to one node.  Every public route is a method listed in
    ROUTES; `call(name, params)` is the single dispatch point."""

    # route name -> method name (identity here, but kept explicit so the
    # surface mirrors rpc/core/routes.go and typos fail loudly)
    ROUTES = (
        "health",
        "status",
        "net_info",
        "genesis",
        "blockchain",
        "block",
        "block_by_hash",
        "block_results",
        "commit",
        "validators",
        "consensus_params",
        "consensus_state",
        "dump_consensus_state",
        "dump_flight_recorder",
        "storage_info",
        "unconfirmed_txs",
        "num_unconfirmed_txs",
        "broadcast_tx_async",
        "broadcast_tx_sync",
        "broadcast_tx_commit",
        "abci_query",
        "abci_info",
        "tx",
        "tx_search",
        "broadcast_evidence",
        # unsafe (gated by cfg.rpc.unsafe; routes.go:48-56)
        "dial_peers",
        "unsafe_flush_mempool",
        "unsafe_start_cpu_profiler",
        "unsafe_stop_cpu_profiler",
        "unsafe_write_heap_profile",
        "unsafe_dump_tasks",
        # chaos control (additionally gated by [chaos] enabled): the
        # process rig's handle on this node's fault layer
        "unsafe_chaos_link",
        "unsafe_chaos_heal",
        "unsafe_chaos_clock_skew",
        "unsafe_chaos_status",
        "unsafe_chaos_disk",
        "unsafe_chaos_rot",
        # store integrity (unsafe: it holds the store lock for a sweep)
        "unsafe_store_integrity_scan",
    )
    UNSAFE = {
        "dial_peers",
        "unsafe_flush_mempool",
        "unsafe_start_cpu_profiler",
        "unsafe_stop_cpu_profiler",
        "unsafe_write_heap_profile",
        "unsafe_dump_tasks",
        "unsafe_chaos_link",
        "unsafe_chaos_heal",
        "unsafe_chaos_clock_skew",
        "unsafe_chaos_status",
        "unsafe_chaos_disk",
        "unsafe_chaos_rot",
        "unsafe_store_integrity_scan",
    }

    #: broadcast routes gated by ingress admission control
    BROADCAST_ROUTES = frozenset(
        {"broadcast_tx_async", "broadcast_tx_sync", "broadcast_tx_commit"}
    )
    #: bound on distinct per-source rate-limit buckets kept live (LRU);
    #: an address-spraying client recycles buckets instead of growing maps
    MAX_SOURCES = 1024

    def __init__(
        self,
        node,
        unsafe: bool = False,
        timeout_broadcast_tx_commit: float = 10.0,
        broadcast_rate: float = 0.0,
        broadcast_rate_burst: int = 200,
        max_broadcast_inflight: int = 1024,
        max_commit_waiters: int = 64,
    ):
        self.node = node
        self.unsafe = unsafe
        self.timeout_broadcast_tx_commit = timeout_broadcast_tx_commit
        # ingress admission control (defaults mirror config.RPCConfig so a
        # bare core — the gRPC broadcast API builds one — is still bounded)
        self.broadcast_rate = broadcast_rate
        self.broadcast_rate_burst = broadcast_rate_burst
        self.max_broadcast_inflight = max_broadcast_inflight
        self.max_commit_waiters = max_commit_waiters
        self._buckets: "collections.OrderedDict[str, TokenBucket]" = collections.OrderedDict()
        self._inflight = 0
        self._commit_waiters = 0
        # plain rejection counter beside the labeled prometheus one: the
        # health watchdog reads it each tick — sustained shedding IS
        # degradation, even when every queue the QoS layer guards stays
        # comfortably bounded (that is the QoS layer working)
        self.throttled_total = 0
        from ..libs.metrics import RPCMetrics
        from ..libs.tracing import NOP as _NOP_RECORDER

        self.metrics = RPCMetrics()  # nop; node swaps in prometheus
        self.recorder = _NOP_RECORDER  # node swaps in its flight recorder
        self.log = get_logger("rpc")
        self._sub_seq = 0
        self._hints: Dict[str, Dict[str, Any]] = {}

    def _coerce(self, method: str, handler, params: Dict[str, Any]) -> Dict[str, Any]:
        """Annotation-driven param conversion, mirroring the reference's
        reflection-based URI binding (rpc/lib/server/http_uri_handler.go):
        a quoted-string URI arg bound to a []byte param becomes raw bytes,
        "5" binds to an int, "true" to a bool."""
        if method not in self._hints:
            import typing

            try:
                self._hints[method] = typing.get_type_hints(handler)
            except Exception:
                self._hints[method] = {}
        hints = self._hints[method]
        out: Dict[str, Any] = {}
        for k, v in params.items():
            t = hints.get(k)
            if t is not None and getattr(t, "__origin__", None) is not None:
                args = [a for a in getattr(t, "__args__", ()) if a is not type(None)]
                t = args[0] if len(args) == 1 else None
            try:
                if t is bytes and isinstance(v, str):
                    v = v.encode()
                elif t is int and isinstance(v, str):
                    v = int(v)
                elif t is float and isinstance(v, str):
                    v = float(v)
                elif t is bool and isinstance(v, str):
                    lv = v.lower()
                    if lv in ("true", "1", "t"):
                        v = True
                    elif lv in ("false", "0", "f"):
                        v = False
                    else:  # strconv.ParseBool errors on anything else
                        raise ValueError(v)
            except ValueError:
                raise RPCError(INVALID_PARAMS, f"bad value for {k!r}: {v!r}")
            out[k] = v
        return out

    async def call(
        self, method: str, params: Optional[Dict[str, Any]] = None, source: str = ""
    ) -> Any:
        """`source` identifies the requesting client (remote address for
        HTTP/WS; empty for trusted in-proc callers) — the key admission
        control rate-limits broadcast routes by."""
        if method not in self.ROUTES:
            raise RPCError(METHOD_NOT_FOUND, f"unknown method {method!r}")
        if method in self.UNSAFE and not self.unsafe:
            raise RPCError(METHOD_NOT_FOUND, f"{method} requires rpc.unsafe=true")
        if method in self.BROADCAST_ROUTES:
            self._throttle_broadcast(source)
        handler = getattr(self, method)
        try:
            return await handler(**self._coerce(method, handler, params or {}))
        except RPCError:
            raise
        except TypeError as e:
            raise RPCError(INVALID_PARAMS, str(e))
        except Exception as e:  # noqa: BLE001 — the API boundary
            self.log.error("rpc handler error", method=method, err=repr(e))
            raise RPCError(INTERNAL_ERROR, repr(e))

    # -- ingress admission control ----------------------------------------

    def _shed(self, reason: str, source: str = "") -> None:
        """One bookkeeping point for every explicit overload rejection:
        the labeled metric, the (sampled) recorder event, and the plain
        counter the watchdog's ingress_shedding detector rates."""
        self.throttled_total += 1
        self.metrics.throttled.labels(reason=reason).inc()
        if source:
            self.recorder.record_sampled("ingress.throttle", reason=reason, source=source)
        else:
            self.recorder.record_sampled("ingress.throttle", reason=reason)

    def _throttle_broadcast(self, source: str) -> None:
        """Per-source token bucket over the broadcast routes.  A source-
        less call (in-proc LocalClient, tests) is trusted — the global
        in-flight bound below still applies to its work."""
        if self.broadcast_rate <= 0 or not source:
            return
        bucket = self._buckets.get(source)
        if bucket is None:
            if len(self._buckets) >= self.MAX_SOURCES:
                self._buckets.popitem(last=False)
            bucket = TokenBucket(self.broadcast_rate, self.broadcast_rate_burst)
            self._buckets[source] = bucket
        else:
            self._buckets.move_to_end(source)
        if not bucket.allow():
            retry = bucket.retry_after()
            self._shed("rate", source)
            raise overloaded_error(
                f"per-source broadcast rate limit ({self.broadcast_rate:g} tx/s) exceeded",
                retry,
            )

    def _acquire_inflight(self) -> None:
        """Claim a slot in the bounded in-flight broadcast queue; reject —
        never queue silently — when it is full."""
        if 0 < self.max_broadcast_inflight <= self._inflight:
            self._shed("inflight")
            raise overloaded_error(
                f"{self._inflight} broadcasts in flight (cap "
                f"{self.max_broadcast_inflight})",
                0.1,
            )
        self._inflight += 1
        self.metrics.broadcast_inflight.set(self._inflight)

    def _release_inflight(self) -> None:
        self._inflight -= 1
        self.metrics.broadcast_inflight.set(self._inflight)

    # -- info routes -------------------------------------------------------

    async def health(self) -> dict:
        """rpc/core/health.go returned a bare `{}`; with the watchdog on
        (libs/watchdog.py) the route serves the aggregate verdict plus the
        active alarms with operator-readable reasons — load-balancer-
        friendly: route away from anything whose `ok` is false.  Without a
        watchdog the reference's empty object survives."""
        wd = getattr(self.node, "watchdog", None)
        if wd is None:
            return {}
        return wd.health()

    async def status(self) -> dict:
        """rpc/core/status.go:32."""
        node = self.node
        bs = node.block_store
        latest_height = bs.height()
        meta = bs.load_block_meta(latest_height) if latest_height else None
        # actual sync phase: statesync (snapshot restore in flight) →
        # fastsync (block replay tail) → caught_up.  `catching_up` used to
        # reflect only the fastsync flag, hiding statesync from readiness
        # gates and dashboards.
        ss = getattr(node, "statesync_reactor", None)
        br = getattr(node, "blockchain_reactor", None)
        if ss is not None and getattr(ss, "syncing", False):
            phase = "statesync"
        elif br is not None and (
            getattr(br, "fast_sync", False) or getattr(br, "wait_statesync", False)
        ):
            phase = "fastsync"
        else:
            phase = "caught_up"
        sync_info = {
            "latest_block_hash": meta.block_id.hash if meta else b"",
            "latest_app_hash": meta.header.app_hash if meta else b"",
            "latest_block_height": latest_height,
            "latest_block_time_ns": meta.header.time_ns if meta else 0,
            "earliest_block_height": bs.base(),
            "catching_up": phase != "caught_up",
            "sync_phase": phase,
        }
        if ss is not None and ss.syncer is not None:
            applied, total = ss.syncer.progress
            sync_info["statesync"] = {"chunks_applied": applied, "chunks_total": total}
        validator_info = {}
        if node.priv_validator is not None:
            pub = node.priv_validator.get_pub_key()
            addr = pub.address()
            power = 0
            if node.consensus is not None and node.consensus.rs.validators is not None:
                _, val = node.consensus.rs.validators.get_by_address(addr)
                if val is not None:
                    power = val.voting_power
            validator_info = {
                "address": addr,
                "pub_key": pub.bytes(),
                "voting_power": power,
            }
        out = {
            "node_info": self._node_info(),
            "sync_info": sync_info,
            "validator_info": validator_info,
        }
        # health summary (verdict + active alarm names): readiness gates
        # and load rigs already poll /status — they can now assert the
        # node SELF-reports degradation instead of inferring it
        wd = getattr(node, "watchdog", None)
        if wd is not None:
            h = wd.health()
            out["health"] = {"verdict": h["verdict"], "alarms": sorted(h["alarms"])}
        return out

    def _node_info(self) -> dict:
        node = self.node
        if node.node_key is not None and node.switch is not None:
            return {
                "id": node.node_key.id,
                "listen_addr": getattr(node.switch.transport, "listen_addr", ""),
                "network": node.genesis_doc.chain_id,
                "moniker": node.config.base.moniker,
            }
        return {
            "id": "",
            "listen_addr": "",
            "network": node.genesis_doc.chain_id,
            "moniker": node.config.base.moniker,
        }

    async def net_info(self) -> dict:
        """rpc/core/net.go:12."""
        sw = self.node.switch
        peers = []
        if sw is not None:
            for peer in list(sw.peers.values()):
                peers.append(
                    {
                        "node_id": peer.id,
                        "moniker": getattr(peer.node_info, "moniker", ""),
                        "is_outbound": getattr(peer, "outbound", False),
                        "remote_addr": getattr(peer, "remote_addr", ""),
                        # rpc/core/net.go ConnectionStatus (flowrate meters)
                        "connection_status": peer.mconn.status(),
                    }
                )
        return {
            "listening": sw is not None,
            "listeners": [getattr(sw.transport, "listen_addr", "")] if sw else [],
            "n_peers": len(peers),
            "peers": peers,
        }

    async def genesis(self) -> dict:
        import json as _json

        return {"genesis": _json.loads(self.node.genesis_doc.to_json())}

    # -- block routes ------------------------------------------------------

    def _height_or_latest(self, height: Optional[int]) -> int:
        latest = self.node.block_store.height()
        if height is None or height <= 0:
            return latest
        base = self.node.block_store.base()
        if height > latest:
            raise RPCError(
                INVALID_PARAMS, f"height {height} must be less than or equal to {latest}"
            )
        if height < base:
            raise RPCError(INVALID_PARAMS, f"height {height} is below base height {base}")
        return height

    async def blockchain(self, min_height: int = 0, max_height: int = 0) -> dict:
        """rpc/core/blocks.go:23 — metas for [min, max], newest first, ≤20."""
        bs = self.node.block_store
        latest = bs.height()
        if max_height <= 0:
            max_height = latest
        max_height = min(max_height, latest)
        if min_height <= 0:
            min_height = 1
        min_height = max(min_height, bs.base(), max_height - 19)
        if min_height > max_height:
            raise RPCError(
                INVALID_PARAMS, f"min_height {min_height} > max_height {max_height}"
            )
        metas = []
        for h in range(max_height, min_height - 1, -1):
            m = bs.load_block_meta(h)
            if m is not None:
                metas.append(m)  # registered type: stays typed through the codec
        return {"last_height": latest, "block_metas": metas}

    async def block(self, height: Optional[int] = None) -> dict:
        h = self._height_or_latest(height)
        meta = self.node.block_store.load_block_meta(h)
        blk = self.node.block_store.load_block(h)
        return {
            "block_id": meta.block_id if meta else None,
            "block": blk,
        }

    async def block_by_hash(self, hash: bytes) -> dict:  # noqa: A002 — route name
        blk = self.node.block_store.load_block_by_hash(hash)
        if blk is None:
            return {"block_id": None, "block": None}
        meta = self.node.block_store.load_block_meta(blk.header.height)
        return {"block_id": meta.block_id if meta else None, "block": blk}

    async def block_results(self, height: Optional[int] = None) -> dict:
        h = self._height_or_latest(height)
        resp = self.node.state_store.load_abci_responses(h)
        if resp is None:
            raise RPCError(INVALID_PARAMS, f"no ABCI responses for height {h}")
        return {"height": h, "results": resp}

    async def commit(self, height: Optional[int] = None) -> dict:
        """rpc/core/blocks.go:126 — header + commit; canonical iff height
        below the store tip (the tip's commit is the mutable seen-commit)."""
        bs = self.node.block_store
        h = self._height_or_latest(height)
        meta = bs.load_block_meta(h)
        if meta is None:
            raise RPCError(INVALID_PARAMS, f"no block meta at height {h}")
        if h == bs.height():
            commit = bs.load_seen_commit(h)
            canonical = False
        else:
            commit = bs.load_block_commit(h)
            canonical = True
        from ..types.block import SignedHeader

        return {
            "signed_header": SignedHeader(meta.header, commit),
            "canonical": canonical,
        }

    async def validators(
        self, height: Optional[int] = None, page: int = 1, per_page: int = 30
    ) -> dict:
        h = self._height_or_latest(height)
        vals = self.node.state_store.load_validators(h)
        if vals is None:
            raise RPCError(INVALID_PARAMS, f"no validator set at height {h}")
        lo, hi = _paginate(vals.size(), page, per_page)
        return {
            "block_height": h,
            "validators": [v.to_dict() for v in vals.validators[lo:hi]],
            "count": hi - lo,
            "total": vals.size(),
        }

    async def consensus_params(self, height: Optional[int] = None) -> dict:
        h = self._height_or_latest(height)
        params = self.node.state_store.load_consensus_params(h)
        return {"block_height": h, "consensus_params": params.to_dict() if params else None}

    # -- consensus introspection ------------------------------------------

    def _round_state_dict(self, full: bool) -> dict:
        cs = self.node.consensus
        if cs is None:
            return {}
        rs = cs.rs
        d = {
            "height": rs.height,
            "round": rs.round,
            "step": rs.step,
            "start_time": rs.start_time,
            "commit_time": rs.commit_time,
            "locked_round": rs.locked_round,
            "valid_round": rs.valid_round,
            "triggered_timeout_precommit": rs.triggered_timeout_precommit,
        }
        if rs.proposal is not None:
            d["proposal"] = rs.proposal.to_dict()
        if rs.locked_block is not None:
            d["locked_block_hash"] = rs.locked_block.hash()
        if rs.valid_block is not None:
            d["valid_block_hash"] = rs.valid_block.hash()
        if rs.votes is not None:
            rounds = {}
            for r in range(rs.round + 1):
                pv, pc = rs.votes.prevotes(r), rs.votes.precommits(r)
                rounds[r] = {
                    "prevotes": str(pv) if pv else None,
                    "precommits": str(pc) if pc else None,
                }
            d["height_vote_set"] = rounds
        if full and rs.validators is not None:
            d["validators"] = rs.validators
        return d

    async def consensus_state(self) -> dict:
        """rpc/core/consensus.go:68 — the compact round-state summary."""
        return {"round_state": self._round_state_dict(full=False)}

    async def dump_consensus_state(self) -> dict:
        """rpc/core/consensus.go:36 — full round state + peer round states."""
        peers = []
        reactor = self.node.consensus_reactor
        if reactor is not None:
            for peer_id, ps in getattr(reactor, "peer_states", {}).items():
                peers.append(
                    {
                        "node_address": peer_id,
                        "peer_round_state": {
                            "height": ps.height,
                            "round": ps.round,
                            "step": getattr(ps, "step", 0),
                        },
                    }
                )
        return {"round_state": self._round_state_dict(full=True), "peers": peers}

    async def dump_flight_recorder(self, since: int = 0, kinds=None) -> dict:
        """Drain the node's flight recorder (libs/tracing.py): the ring of
        consensus-step, gossip, verify-engine and scheduler-profiler span
        events.  `since` is a seq watermark — pass the previous response's
        `next_seq` to poll only fresh events.  `kinds` filters by event-
        kind prefix (list, or comma-separated string: "step,gossip."); the
        snapshot carries a freshly-sampled monotonic→wall `anchor` plus
        this node's moniker so `trace-net` can merge dumps from different
        nodes onto one timeline.  Safe route: bounded payload (ring-
        sized), no node mutation."""
        rec = getattr(self.node, "flight_recorder", None)
        if rec is None:
            return {"enabled": False, "size": 0, "next_seq": 0, "dropped": 0, "events": []}
        if isinstance(kinds, str):
            kinds = [k for k in kinds.split(",") if k]
        elif kinds is not None:
            # caller-supplied over HTTP: keep only string entries instead
            # of letting a junk element TypeError inside the ring scan
            kinds = [k for k in kinds if isinstance(k, str)] if isinstance(
                kinds, (list, tuple)
            ) else None
        snap = rec.snapshot(since=int(since), kinds=kinds or None)
        cfg = getattr(self.node, "config", None)
        if cfg is not None:
            snap["node"] = cfg.base.moniker
        return snap

    # -- mempool routes ----------------------------------------------------

    async def unconfirmed_txs(self, limit: int = 30) -> dict:
        limit = max(1, min(limit, _MAX_PER_PAGE))
        txs = self.node.mempool.reap_max_txs(limit)
        return {
            "n_txs": len(txs),
            "total": self.node.mempool.size(),
            "txs": txs,
        }

    async def num_unconfirmed_txs(self) -> dict:
        return {"n_txs": self.node.mempool.size(), "total": self.node.mempool.size()}

    async def broadcast_tx_async(self, tx: bytes) -> dict:
        """rpc/core/mempool.go:22 — fire and forget, but BOUNDED: the
        CheckTx work claims an in-flight slot (released when it finishes)
        so a firehose of async broadcasts queues explicit rejections, not
        unbounded tasks."""
        self._acquire_inflight()
        task = asyncio.ensure_future(self.node.mempool.check_tx(tx))

        def _done(t: asyncio.Task) -> None:
            self._release_inflight()
            if t.cancelled():
                return
            # rejections are expected fire-and-forget outcomes, but the
            # shedding ones must still be OBSERVABLE — async mode gave the
            # client code 0 up front, so telemetry is the only signal left
            exc = t.exception()
            if isinstance(exc, MempoolFullError):
                self._shed("mempool_full")

        task.add_done_callback(_done)
        return {"code": 0, "data": b"", "log": "", "hash": tx_hash(tx)}

    async def broadcast_tx_sync(self, tx: bytes) -> dict:
        """rpc/core/mempool.go:36 — wait for CheckTx."""
        self._acquire_inflight()
        try:
            res = await self.node.mempool.check_tx(tx)
        except MempoolFullError as e:
            self._shed("mempool_full")
            raise overloaded_error(str(e), 1.0)
        finally:
            self._release_inflight()
        return {
            "code": res.code,
            "data": res.data,
            "log": res.log,
            "hash": tx_hash(tx),
        }

    async def broadcast_tx_commit(self, tx: bytes) -> dict:
        """rpc/core/mempool.go:56 — CheckTx, then wait for the DeliverTx
        event via an EventBus subscription (the reference flow verbatim:
        subscribe first so the commit can't race the wait).  Concurrent
        waiters are CAPPED: each holds an event-bus subscription for up to
        timeout_broadcast_tx_commit, so under a commit stall an uncapped
        route would pile subscriptions onto the bus without bound."""
        if 0 < self.max_commit_waiters <= self._commit_waiters:
            self._shed("commit_waiters")
            raise overloaded_error(
                f"{self._commit_waiters} broadcast_tx_commit waiters (cap "
                f"{self.max_commit_waiters})",
                self.timeout_broadcast_tx_commit,
            )
        self._commit_waiters += 1
        self.metrics.commit_waiters.set(self._commit_waiters)
        try:
            return await self._broadcast_tx_commit(tx)
        finally:
            self._commit_waiters -= 1
            self.metrics.commit_waiters.set(self._commit_waiters)

    async def _broadcast_tx_commit(self, tx: bytes) -> dict:
        bus = self.node.event_bus
        h = tx_hash(tx)
        self._sub_seq += 1
        subscriber = f"broadcast_tx_commit-{self._sub_seq}"
        q = f"{EVENT_TYPE_KEY}='{EVENT_TX}' AND {TX_HASH_KEY}='{h.hex().upper()}'"
        sub = await bus.subscribe(subscriber, q)
        try:
            self._acquire_inflight()
            try:
                check = await self.node.mempool.check_tx(tx)
            except MempoolFullError as e:
                self._shed("mempool_full")
                raise overloaded_error(str(e), 1.0)
            finally:
                self._release_inflight()
            if check.code != 0:
                return {
                    "check_tx": check,
                    "deliver_tx": None,
                    "hash": h,
                    "height": 0,
                }
            try:
                msg = await asyncio.wait_for(sub.next(), self.timeout_broadcast_tx_commit)
            except asyncio.TimeoutError:
                raise RPCError(INTERNAL_ERROR, "timed out waiting for tx to be included in a block")
            data = msg.data.data  # Message.data is the Event; Event.data the payload
            return {
                "check_tx": check,
                "deliver_tx": data["result"],
                "hash": h,
                "height": data["height"],
            }
        finally:
            await bus.unsubscribe_all(subscriber)

    # -- abci routes -------------------------------------------------------

    async def abci_query(
        self, path: str = "", data: bytes = b"", height: int = 0, prove: bool = False
    ) -> dict:
        res = await self.node.proxy_app.query().query(
            RequestQuery(data=data, path=path, height=height, prove=prove)
        )
        return {"response": res}

    async def abci_info(self) -> dict:
        res = await self.node.proxy_app.query().info(RequestInfo(version="rpc"))
        return {"response": res}

    # -- tx index routes ---------------------------------------------------

    async def tx(self, hash: bytes, prove: bool = False) -> dict:  # noqa: A002
        res = self.node.tx_indexer.get(hash)
        if res is None:
            raise RPCError(INVALID_PARAMS, f"tx ({hash.hex()}) not found")
        out = dict(res)
        out["hash"] = hash
        if prove:
            proof = self._tx_proof(res["height"], res["index"])
            if proof is not None:
                out["proof"] = proof
        return out

    def _tx_proof(self, height: int, index: int):
        """Merkle proof of tx inclusion under the block's data_hash
        (types/tx.go Txs.Proof)."""
        from ..crypto.merkle import proofs_from_byte_slices
        from ..types.tx import tx_hash as _th

        blk = self.node.block_store.load_block(height)
        if blk is None or index >= len(blk.txs):
            return None
        root, proofs = proofs_from_byte_slices([_th(t) for t in blk.txs])
        return {"root_hash": root, "proof": proofs[index].to_dict()}

    async def tx_search(
        self, query: str, prove: bool = False, page: int = 1, per_page: int = 30
    ) -> dict:
        results = self.node.tx_indexer.search(query, limit=10_000)
        lo, hi = _paginate(len(results), page, per_page)
        txs = []
        for res in results[lo:hi]:
            out = dict(res)
            if prove and "height" in res and "index" in res:
                proof = self._tx_proof(res["height"], res["index"])
                if proof is not None:
                    out["proof"] = proof
            txs.append(out)
        return {"txs": txs, "total_count": len(results)}

    # -- evidence ----------------------------------------------------------

    async def broadcast_evidence(self, evidence) -> dict:
        self.node.evidence_pool.add_evidence(evidence)
        return {"hash": evidence.hash()}

    # -- unsafe ------------------------------------------------------------

    async def dial_peers(self, peers: list, persistent: bool = False) -> dict:
        if self.node.switch is None:
            raise RPCError(INTERNAL_ERROR, "p2p is disabled")
        await self.node.switch.dial_peers_async(list(peers), persistent=persistent)
        return {"log": f"dialing {len(peers)} peers"}

    async def unsafe_flush_mempool(self) -> dict:
        await self.node.mempool.flush()
        return {}

    # -- chaos control (config-gated: [chaos] enabled AND rpc.unsafe) ------

    def _require_chaos(self) -> None:
        """The ONE config gate for every chaos route (on top of the
        rpc.unsafe gate `call` already enforces) — kept in one place so a
        future tightening cannot silently miss a route."""
        if not getattr(self.node.config.chaos, "enabled", False):
            raise RPCError(INTERNAL_ERROR, "chaos routes require [chaos] enabled")

    def _chaos_table(self, required: bool = True):
        self._require_chaos()
        table = getattr(self.node.switch, "link_policies", None) if self.node.switch else None
        if table is None and required:
            raise RPCError(INTERNAL_ERROR, "no link-policy table (p2p disabled?)")
        return table

    async def unsafe_chaos_link(
        self,
        peer_id: str = "*",
        drop: float = 0.0,
        delay: float = 0.0,
        jitter: float = 0.0,
        rate: float = 0.0,
    ) -> dict:
        """Set this node's OUTBOUND link policy toward `peer_id` ("*" =
        every peer).  drop=1.0 partitions the link; all-zero heals it.
        A scenario orchestrator (`chip_smoke.py` phase 17) stages
        partitions by setting drop=1.0 symmetrically on both nodes."""
        from ..chaos.link import degraded

        table = self._chaos_table()
        table.set_policy(peer_id, degraded(drop=drop, delay=delay, jitter=jitter, rate=rate))
        return {"policies": table.policies()}

    async def unsafe_chaos_heal(self) -> dict:
        """Clear every link policy — the partition heals."""
        table = self._chaos_table()
        table.heal()
        return {"policies": table.policies()}

    async def unsafe_chaos_clock_skew(self, skew: float = 0.0) -> dict:
        """Skew this node's consensus wall clock by `skew` seconds."""
        self._require_chaos()
        from ..chaos.clock import SkewedClock

        clock = getattr(self.node, "chaos_clock", None)
        if clock is None:
            clock = SkewedClock(
                skew,
                metrics=getattr(self.node.metrics_provider, "chaos", None),
                recorder=self.node.flight_recorder,
            )
            self.node.chaos_clock = clock
            self.node.consensus.clock = clock
        else:
            clock.set_skew(skew)
        return {"skew": clock.skew_s}

    async def unsafe_chaos_status(self) -> dict:
        """Active fault state: link policies, fault counters, clock skew,
        twin equivocation count — the rig's view of what is injected."""
        table = self._chaos_table(required=False)
        clock = getattr(self.node, "chaos_clock", None)
        pv = self.node.priv_validator
        return {
            "enabled": True,
            "twin": bool(self.node.config.chaos.twin),
            "equivocations": getattr(pv, "equivocations", 0),
            "clock_skew_s": clock.skew_s if clock is not None else 0.0,
            "policies": table.policies() if table is not None else {},
            "counters": table.counters() if table is not None else {},
        }

    async def unsafe_chaos_disk(
        self, kind: str, store: str = "*", p: float = 1.0
    ) -> dict:
        """Set (or with kind="heal" clear) a disk-fault policy on this
        node's stores — the process rig's handle on chaos/disk.py.  kind
        in enospc|eio|eio_fsync|torn|fsync_lie|bitrot|heal; store names a
        single store or "*"."""
        self._require_chaos()
        table = getattr(self.node, "disk_faults", None)
        if table is None:
            raise RPCError(INTERNAL_ERROR, "no disk-fault table ([chaos] enabled?)")
        from ..chaos.disk import policy_for

        if kind == "heal":
            table.heal(None if store == "*" else store)
        else:
            try:
                table.set_policy(store, policy_for(kind, p))
            except ValueError as e:
                raise RPCError(INVALID_PARAMS, str(e))
        return {"policies": table.policies(), "counters": table.counters()}

    async def unsafe_chaos_rot(
        self, height: int, store: str = "blockstore", part: int = 0
    ) -> dict:
        """Persistent seeded bit-rot: flip one byte inside the stored
        block part (height, part) — restart-surviving cell damage the
        integrity scan must detect and quarantine."""
        self._require_chaos()
        if store != "blockstore":
            raise RPCError(INVALID_PARAMS, f"rot supports 'blockstore' only, got {store!r}")
        from ..chaos.disk import rot_block_store

        seed = getattr(self.node.config.chaos, "seed", 0)
        try:
            info = rot_block_store(self.node.block_store, height, seed=seed, part_index=part)
        except ValueError as e:
            raise RPCError(INVALID_PARAMS, str(e))
        return {"rotted": info, "height": height}

    # -- store integrity ----------------------------------------------------

    async def storage_info(self) -> dict:
        """Per-store persistence posture: fault counters + halts (the
        StorageHealth summary incl. free space), quarantine state, last
        integrity scan, per-store disk usage and WAL/spool chunk counts —
        the live half of a debug bundle's storage section."""
        node = self.node
        out: dict = {"health": node.storage_health.summary()}
        bs = node.block_store
        out["blockstore"] = {
            "base": bs.base(),
            "height": bs.height(),
            "quarantined": bs.quarantined(),
            "last_scan": bs.last_scan,
        }
        from ..libs.autofile import dir_usage, group_disk_stats

        cfg = node.config
        out["disk_usage"] = dir_usage(cfg.db_dir())
        wals = {}
        cs_stats = group_disk_stats(cfg.wal_file())
        if cs_stats is not None:
            wal = getattr(node.consensus, "wal", None)
            cs_stats["corrupt_regions_skipped"] = getattr(wal, "corrupt_regions_skipped", 0)
            cs_stats["corrupt_bytes_skipped"] = getattr(wal, "corrupt_bytes_skipped", 0)
            wals["consensus_wal"] = cs_stats
        if cfg.mempool.wal_dir:
            mp_stats = group_disk_stats(os.path.join(cfg.mempool_wal_dir(), "wal"))
            if mp_stats is not None:
                wals["mempool_wal"] = mp_stats
        spool_stats = group_disk_stats(cfg.flight_spool_file())
        if spool_stats is not None:
            wals["flight_spool"] = spool_stats
        out["wals"] = wals
        if node.disk_faults is not None:
            out["chaos"] = {
                "policies": node.disk_faults.policies(),
                "injected": node.disk_faults.counters(),
            }
        br = getattr(node, "blockchain_reactor", None)
        if br is not None:
            out["refill"] = {
                "pending": sorted(br.refill_heights),
                "refilled": br.refilled,
            }
        return out

    async def unsafe_store_integrity_scan(self, limit: int = 0) -> dict:
        """Run the block-store integrity sweep NOW (on an executor
        thread), quarantining anything corrupt and kicking the peer
        refill.  `limit` bounds the sweep to the most recent N heights
        (0 = base..tip)."""
        node = self.node
        report = await asyncio.get_event_loop().run_in_executor(
            None, lambda: node.block_store.integrity_scan(limit)
        )
        br = getattr(node, "blockchain_reactor", None)
        if br is not None and report["quarantined"]:
            br.request_refill(report["quarantined"])
        return report

    # -- profiling/debug routes (routes.go:48-56; cProfile stands in for
    # pprof, an asyncio task dump for the goroutine dump) ------------------

    async def unsafe_start_cpu_profiler(self, filename: str = "cpu.prof") -> dict:
        import cProfile

        if getattr(self, "_profiler", None) is not None:
            raise RPCError(INTERNAL_ERROR, "cpu profiler already running")
        self._profiler = cProfile.Profile()
        self._profiler_file = filename
        self._profiler.enable()
        return {}

    async def unsafe_stop_cpu_profiler(self) -> dict:
        prof = getattr(self, "_profiler", None)
        if prof is None:
            raise RPCError(INTERNAL_ERROR, "cpu profiler not running")
        prof.disable()
        prof.dump_stats(self._profiler_file)
        self._profiler = None
        return {"filename": self._profiler_file}

    async def unsafe_write_heap_profile(self, filename: str = "heap.prof") -> dict:
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start()
            return {"log": "tracemalloc started; call again for a snapshot"}
        snap = tracemalloc.take_snapshot()
        lines = [str(stat) for stat in snap.statistics("lineno")[:200]]
        with open(filename, "w") as f:
            f.write("\n".join(lines))
        return {"filename": filename, "entries": len(lines)}

    async def unsafe_dump_tasks(self) -> dict:
        """Our goroutine dump: every live asyncio task with its stack."""
        import io
        import traceback

        tasks = []
        for task in asyncio.all_tasks():
            buf = io.StringIO()
            task.print_stack(limit=8, file=buf)
            tasks.append({
                "name": task.get_name(),
                "done": task.done(),
                "stack": buf.getvalue(),
            })
        return {"n_tasks": len(tasks), "tasks": tasks}


def now_ns() -> int:
    return time.time_ns()
