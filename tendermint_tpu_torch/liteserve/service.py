"""liteserve: the multi-tenant light-client verification gateway.

One shared verification engine fronts a chain for many light clients:

  - a single shared lite2 ``Client`` over one shared ``LightStore``,
    snapshot-bootstrapped at the configured trust root (bootstrap.py), so
    the store spans [root, tip] before the first tenant arrives;
  - the shared ``VerifyCache`` (cache.py) under the client's
    ``commit_preverify`` hook — each (chain, height, header_hash) commit
    pays its signature batch / pairing once, process-wide;
  - request-level **single-flight**: concurrent ``lite_commit`` calls for
    the same height join one in-flight verification future (the
    ``lite_verify_coalesce_ratio`` bench key measures exactly this);
  - **witness-diversity rotation** (witness.py): each verification pass
    cross-checks against a seeded rotating subset of the witness pool;
  - **adversarial-primary recovery**: a ``DivergedHeaderError`` triggers a
    majority re-check across the whole pool — if most responsive
    witnesses contradict the primary, the primary is demoted and a
    witness promoted in its place (and the lying pass's headers were
    already rolled back by the client, so nothing poisoned entered the
    shared store); a lying minority of witnesses is demoted instead.
    Either way the gateway keeps serving every other tenant throughout.

Service surface: JSON-RPC routes (``lite_commit``, ``lite_block``,
``lite_validators``, ``lite_status``, ``lite_session_new``,
``lite_session_resume``), ``tendermint_liteserve_*`` metrics,
``liteserve.*`` flight-recorder events, and the ``tendermint_tpu_torch
liteserve`` CLI entry (cli.py).

The port's copy of tendermint_tpu/liteserve/service.py.  The JAX gateway
serves on aiohttp; this one on rpc/http.py, the HTTP/1.1 layer under the
port's RPC server, with the same routes, statuses and JSON bodies and the
body bound of `read_bounded_body`.  Cache misses verify through
`async_verifier` (the node's AsyncBatchVerifier lane, or the card's engine
the `liteserve` command installs), else through the installed
crypto.batch hook.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List, Optional
from urllib.parse import parse_qsl

from ..libs.log import get_logger
from ..libs.tracing import FlightRecorder
from ..lite2 import Client, DivergedHeaderError, TrustOptions
from ..lite2.client import LightClientError
from ..lite2.provider import Provider, ProviderError
from ..lite2.store import LightStore, MemStore
from ..rpc.jsonrpc import (
    INTERNAL_ERROR,
    INVALID_PARAMS,
    PARSE_ERROR,
    RPCError,
    from_jsonable,
    make_response,
    read_bounded_body,
)
from ..rpc import http
from ..types.block import SignedHeader
from .bootstrap import snapshot_bootstrap
from .cache import VerifyCache
from .sessions import SessionManager
from .witness import WitnessPool


class LiteServe:
    """The gateway.  Construct with a primary + witness providers and a
    trust root; `start()` bootstraps the shared store and serves."""

    ROUTES = {
        "lite_session_new": "_rpc_session_new",
        "lite_session_resume": "_rpc_session_resume",
        "lite_commit": "_rpc_commit",
        "lite_block": "_rpc_block",
        "lite_validators": "_rpc_validators",
        "lite_status": "_rpc_status",
    }

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: List[Provider],
        *,
        laddr: str = "tcp://127.0.0.1:8899",
        store: Optional[LightStore] = None,
        cache_capacity: int = 4096,
        max_sessions: int = 4096,
        idle_timeout_s: float = 300.0,
        session_rate: float = 0.0,
        session_burst: int = 50,
        create_rate: float = 0.0,
        create_burst: int = 20,
        witness_quorum: int = 2,
        witness_timeout_s: float = 3.0,
        rotation_seed: int = 0,
        max_body_bytes: int = 1_000_000,
        async_verifier=None,
        metrics=None,
        metrics_provider=None,
        recorder: Optional[FlightRecorder] = None,
        now_fn=time.time_ns,
        witness_addrs: Optional[List[str]] = None,
        primary_addr: str = "",
    ):
        self.chain_id = chain_id
        self.laddr = laddr
        self.max_body_bytes = max_body_bytes
        self.metrics = metrics
        self.metrics_provider = metrics_provider
        self.recorder = recorder if recorder is not None else FlightRecorder(size=4096)
        self.log = get_logger("liteserve")

        self.store = store or MemStore()
        self.cache = VerifyCache(
            capacity=cache_capacity, async_verifier=async_verifier,
            recorder=self.recorder,
        )
        self.pool = WitnessPool(seed=rotation_seed, quorum=witness_quorum)
        addrs = witness_addrs or [""] * len(witnesses)
        for w, a in zip(witnesses, addrs):
            self.pool.add(w, addr=a)
        self.primary_addr = primary_addr
        self.witness_timeout_s = witness_timeout_s
        self.client = Client(
            chain_id,
            trust_options,
            primary,
            witnesses=[],  # rotated in per verification pass from the pool
            store=self.store,
            commit_preverify=self.cache.preverify(),
            witness_timeout_s=witness_timeout_s,
            now_fn=now_fn,
            on_witness_demoted=lambda w: self.pool.demote(w, reason="client error score"),
        )
        self.sessions = SessionManager(
            max_sessions=max_sessions,
            idle_timeout_s=idle_timeout_s,
            session_rate=session_rate,
            session_burst=session_burst,
            create_rate=create_rate,
            create_burst=create_burst,
        )

        self._verify_lock = asyncio.Lock()
        self._vflight: Dict[int, asyncio.Future] = {}
        self.lookup_hits = 0
        self.lookup_misses = 0
        self.coalesced_requests = 0
        self.bisections_total = 0
        self.diverged_detected = 0
        self.primary_replacements = 0
        self.demoted_primaries: List[str] = []
        self.started_at = 0.0
        self.listen_addr = ""
        self._http = http.HTTPServer(
            self._route, max_body_bytes=max_body_bytes, logger="liteserve"
        )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        t0 = time.monotonic()
        tip = await snapshot_bootstrap(self.client, verify=self._verify_with_recovery)
        self.recorder.record(
            "liteserve.bootstrap", tip=tip,
            root=self.client.trust_options.height,
            ms=round((time.monotonic() - t0) * 1e3, 2),
        )
        self.listen_addr = await self._http.start(self.laddr)
        self.started_at = time.monotonic()
        self.log.info(
            "liteserve listening", laddr=self.listen_addr, tip=tip,
            witnesses=self.pool.size(),
        )

    async def stop(self) -> None:
        await self._http.stop()
        for p in (self.client.primary, *self.pool.providers(),
                  *(s.provider for s in self.pool.demoted)):
            close = getattr(p, "close", None)
            if close is not None:
                try:
                    await close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    # -- shared verification engine ----------------------------------------

    async def verified_header(self, height: int) -> SignedHeader:
        """The one door every tenant's read goes through: shared-store hit,
        else single-flight coalesced verification with witness rotation and
        adversarial-primary recovery."""
        if height == 0:
            latest = await self.client.primary.signed_header(0)
            height = latest.height
        sh = self.store.signed_header(height)
        if sh is not None:
            self.lookup_hits += 1
            self._gauge("cache_hits", self.lookup_hits)
            return sh
        fut = self._vflight.get(height)
        if fut is not None:
            self.coalesced_requests += 1
            self._gauge("coalesced_verifies", self.coalesced_requests)
            return await asyncio.shield(fut)
        self.lookup_misses += 1
        self._gauge("cache_misses", self.lookup_misses)
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        self._vflight[height] = fut
        try:
            sh = await self._verify_with_recovery(height)
        except BaseException as e:
            fut.set_exception(e)
            raise
        else:
            fut.set_result(sh)
            return sh
        finally:
            self._vflight.pop(height, None)

    async def _verify_with_recovery(self, height: int) -> SignedHeader:
        for _attempt in range(3):
            async with self._verify_lock:
                consulted = self.pool.select()
                self.client.witnesses = list(consulted)
                t0 = time.monotonic()
                try:
                    sh = await self.client.verify_header_at_height(height)
                except DivergedHeaderError as e:
                    self.diverged_detected += 1
                    self._gauge("diverged_headers", self.diverged_detected)
                    self.recorder.record(
                        "liteserve.diverged", height=e.height,
                        witness_idx=e.witness_idx,
                    )
                    self.log.info("diverged header", height=e.height)
                    await self._handle_divergence(e.height)
                    continue
                self.bisections_total += 1
                self._gauge("bisections_total", self.bisections_total)
                for w in consulted:
                    self.pool.report_ok(w)
                self.recorder.record_sampled(
                    "liteserve.bisection", height=height,
                    ms=round((time.monotonic() - t0) * 1e3, 2),
                )
                return sh
        raise LightClientError(f"divergence at height {height} unresolved after retries")

    async def _handle_divergence(self, height: int) -> None:
        """Majority re-check across the WHOLE active pool: who is lying —
        the primary, or the witness that cried fork?"""
        try:
            mine = await asyncio.wait_for(
                self.client.primary.signed_header(height), self.witness_timeout_s
            )
        except (ProviderError, asyncio.TimeoutError):
            # a primary that can't even re-serve its own header is dead or
            # evasive: replace it
            self._replace_primary("primary dark during divergence re-check")
            return
        witnesses = list(self.pool.active)

        async def ask(slot):
            try:
                alt = await asyncio.wait_for(
                    slot.provider.signed_header(height), self.witness_timeout_s
                )
            except (ProviderError, asyncio.TimeoutError):
                return (slot, None)
            return (slot, alt.header.hash())

        results = await asyncio.gather(*(ask(s) for s in witnesses))
        my_hash = mine.header.hash()
        agree = [s for s, h in results if h == my_hash]
        disagree = [s for s, h in results if h is not None and h != my_hash]
        if len(disagree) >= max(1, len(agree) + 1) or (disagree and not agree):
            # most responsive witnesses contradict the primary: the primary
            # is the liar.  Its pass was already rolled back by the client —
            # nothing it served survives in the shared store.
            self._replace_primary(
                f"{len(disagree)}/{len(disagree) + len(agree)} witnesses "
                f"contradict primary at height {height}"
            )
        else:
            # a lying minority: demote them, keep the primary
            for s in disagree:
                self.pool.demote(s.provider, reason=f"diverged alone at height {height}")
                self.recorder.record(
                    "liteserve.demote_witness", height=height, addr=s.addr,
                )
            self._gauge("witness_demotions", self.pool.total_demotions)

    def _replace_primary(self, reason: str) -> None:
        old = self.primary_addr or type(self.client.primary).__name__
        new = self.pool.promote()  # raises LookupError when exhausted
        self.client.primary = new
        self.primary_replacements += 1
        self.demoted_primaries.append(old)
        self.primary_addr = next(
            (s.addr for s in self.pool.demoted + self.pool.active if s.provider is new),
            "",
        ) or type(new).__name__
        self._gauge("primary_replacements", self.primary_replacements)
        self.recorder.record(
            "liteserve.demote_primary", old=old, new=self.primary_addr, reason=reason,
        )
        self.log.info("demoted primary", old=old, new=self.primary_addr, reason=reason)

    def _gauge(self, name: str, value) -> None:
        if self.metrics is not None:
            getattr(self.metrics, name).set(value)

    # -- RPC handlers ------------------------------------------------------

    async def _rpc_session_new(
        self, source: str, trust_height: int = 0, trust_hash="", **_kw
    ) -> dict:
        if isinstance(trust_hash, str):
            try:
                trust_hash = bytes.fromhex(trust_hash)
            except ValueError:
                raise RPCError(INVALID_PARAMS, "trust_hash must be hex or bytes")
        sess = self.sessions.create(source, int(trust_height), trust_hash)
        # root the tenant: its subjective trust root must BE a header of
        # the service's verified chain — a conflicting root means the
        # tenant is on a fork this gateway cannot serve
        try:
            sh = await self.verified_header(sess.trust_height)
        except Exception:
            self.sessions.drop(sess.sid)
            raise
        if sh.header.hash() != sess.trust_hash:
            self.sessions.drop(sess.sid)
            raise RPCError(
                INVALID_PARAMS,
                f"trust root at height {sess.trust_height} conflicts with the "
                f"verified chain (expected {sh.header.hash().hex()})",
            )
        sess.rooted = True
        self._gauge("sessions", len(self.sessions.sessions))
        self.recorder.record_sampled(
            "liteserve.session", sid=sess.sid, root=sess.trust_height,
        )
        return {
            "session": sess.sid,
            "trust_height": sess.trust_height,
            "latest_trusted_height": self.store.latest_height(),
        }

    async def _rpc_session_resume(self, source: str, session: str = "", **_kw) -> dict:
        sess = self.sessions.resume(session)
        return {
            "session": sess.sid,
            "trust_height": sess.trust_height,
            "requests": sess.requests,
            "latest_trusted_height": self.store.latest_height(),
        }

    async def _rpc_commit(self, source: str, session: str = "", height: int = 0, **_kw) -> dict:
        sess = self.sessions.get(session)
        sess.admit()
        before = self.store.signed_header(height) is not None if height else False
        sh = await self.verified_header(int(height))
        if not before:
            sess.bisections += 1
        return {"signed_header": sh, "canonical": True}

    async def _rpc_block(self, source: str, session: str = "", height: int = 0, **_kw) -> dict:
        sess = self.sessions.get(session)
        sess.admit()
        sh = await self.verified_header(int(height))
        rpc_client = getattr(self.client.primary, "client", None)
        if rpc_client is None:
            raise RPCError(INTERNAL_ERROR, "primary provider cannot serve full blocks")
        res = await rpc_client.block(sh.height)
        blk = res.get("block")
        if blk is None or blk.hash() != sh.header.hash():
            raise RPCError(INTERNAL_ERROR, "primary served a block not matching verified header")
        return res

    async def _rpc_validators(self, source: str, session: str = "", height: int = 0, **_kw) -> dict:
        sess = self.sessions.get(session)
        sess.admit()
        sh = await self.verified_header(int(height))
        vals = self.store.validator_set(sh.height)
        if vals is None:
            vals = await self.client.primary.validator_set(sh.height)
            if sh.header.validators_hash != vals.hash():
                raise RPCError(INTERNAL_ERROR, "primary served wrong validator set")
        return {
            "block_height": sh.height,
            "validators": [v.to_dict() for v in vals.validators],
            "total": vals.size(),
        }

    async def _rpc_status(self, source: str, **_kw) -> dict:
        total = self.lookup_hits + self.lookup_misses + self.coalesced_requests
        return {
            "liteserve": True,
            "chain_id": self.chain_id,
            "latest_trusted_height": self.store.latest_height(),
            "first_trusted_height": self.store.first_height(),
            "primary": self.primary_addr,
            "uptime_s": round(time.monotonic() - self.started_at, 1)
            if self.started_at else 0.0,
            "sessions": self.sessions.stats(),
            "verify": {
                "lookups": total,
                "hits": self.lookup_hits,
                "misses": self.lookup_misses,
                "coalesced": self.coalesced_requests,
                "hit_ratio": round(self.lookup_hits / total, 4) if total else 0.0,
                "coalesce_ratio": round(self.coalesced_requests / total, 4)
                if total else 0.0,
                "bisections": self.bisections_total,
                "diverged_detected": self.diverged_detected,
                "primary_replacements": self.primary_replacements,
                "demoted_primaries": self.demoted_primaries,
            },
            "commit_cache": self.cache.stats(),
            "witnesses": self.pool.stats(),
        }

    # -- HTTP plumbing -----------------------------------------------------

    async def _dispatch(self, method: str, params: dict, req_id, source: str) -> dict:
        name = self.ROUTES.get(method)
        if name is None:
            return make_response(req_id, error=RPCError(INVALID_PARAMS, f"unknown route {method}"))
        try:
            return make_response(req_id, await getattr(self, name)(source, **params))
        except RPCError as e:
            return make_response(req_id, error=e)
        except DivergedHeaderError as e:
            return make_response(req_id, error=RPCError(INTERNAL_ERROR, f"diverged: {e}"))
        except Exception as e:  # noqa: BLE001
            return make_response(req_id, error=RPCError(INTERNAL_ERROR, repr(e)))

    async def _route(self, req: http.Request):
        """The JAX gateway's aiohttp routes: POST /, GET /metrics (with a
        registry), GET /{method}."""
        path, method = req.path, req.method
        get = method in ("GET", "HEAD")
        if path == "/":
            if method != "POST":
                return http.NOT_ALLOWED
            return http.json_answer(await self._handle_post(req.body, req.source))
        segment = path[1:]
        if "/" in segment or not segment:
            return http.NOT_FOUND
        if not get:
            return http.NOT_ALLOWED
        if (segment == "metrics" and self.metrics_provider is not None
                and self.metrics_provider.registry is not None):
            return (200, self.metrics_provider.exposition(),
                    "text/plain; version=0.0.4; charset=utf-8")
        return http.json_answer(await self._handle_get(segment, req.query, req.source))

    async def _handle_post(self, body: http.Body, source: str) -> dict:
        try:
            raw = await read_bounded_body(body, self.max_body_bytes)
        except RPCError as e:
            return make_response(None, error=e)
        try:
            req = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return make_response(None, error=RPCError(PARSE_ERROR, "invalid JSON"))
        if not isinstance(req, dict) or "method" not in req:
            return make_response(None, error=RPCError(INVALID_PARAMS, "malformed request"))
        params = from_jsonable(req.get("params") or {})
        if not isinstance(params, dict):
            return make_response(
                req.get("id"), error=RPCError(INVALID_PARAMS, "params must be an object")
            )
        return await self._dispatch(req.get("method", ""), params, req.get("id"), source)

    async def _handle_get(self, method: str, query: str, source: str) -> dict:
        params = {}
        for k, v in parse_qsl(query, keep_blank_values=True):
            try:
                params[k] = int(v)
            except ValueError:
                params[k] = v
        return await self._dispatch(method, params, -1, source)


async def run_service(
    chain_id: str,
    primary_addr: str,
    witness_addrs: List[str],
    laddr: str,
    trust_height: int,
    trust_hash: bytes,
    trusting_period_s: float,
    **kwargs,
) -> None:
    """CLI entry (`tendermint_tpu_torch liteserve`) — runs until cancelled."""
    from ..lite2.provider import HTTPProvider

    service = LiteServe(
        chain_id,
        TrustOptions(int(trusting_period_s * 1e9), trust_height, trust_hash),
        HTTPProvider(chain_id, primary_addr),
        [HTTPProvider(chain_id, w) for w in witness_addrs],
        laddr=laddr,
        primary_addr=primary_addr,
        witness_addrs=witness_addrs,
        **kwargs,
    )
    await service.start()
    print(f"liteserve started: chain={chain_id} laddr={service.listen_addr}", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    except asyncio.CancelledError:
        pass
    finally:
        await service.stop()
