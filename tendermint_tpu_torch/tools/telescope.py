"""Live fleet telescope: one terminal watching a whole network (the port's
copy of tendermint_tpu/tools/telescope.py; its snapshot endpoint runs on
the port's rpc/http.py where the JAX one runs on aiohttp).

A collector that continuously polls every node's `dump_flight_recorder`
(with per-node seq watermarks so each sweep only ships fresh events),
`status` and `health` routes, live-merges the rolling event window into
one network timeline (libs/tracemerge — MEASURED clock skew whenever
peers speak the wire trace tier, landmark estimation otherwise), and
computes fleet health on every sweep:

  - tip spread and per-node height lag,
  - vote-fan-in-to-quorum latency (median across nodes of each node's
    net_budget vote_fanin stage),
  - gossip-hop propagation latency pooled across the fleet,
  - stalled part streams (a height whose part stream started but never
    completed within the stall threshold),
  - clamped (byzantine-implausible) trace fields seen fleet-wide.

Served two ways at once: a refreshing text dashboard on the terminal and
an optional JSON snapshot endpoint (`GET /snapshot`, on rpc/http.py — the
same shape `debug watch --once` prints) for scripts and harnesses.

Nodes dying mid-run is the NORMAL case this tool exists for: every
per-node poll is independently fallible (like `debug dump` sections), a
dead node stays on the board marked DOWN with its last-known state, and
the survivors' timeline keeps merging from their buffered windows.

CLI: `python -m tendermint_tpu_torch debug watch --rpc
127.0.0.1:26657,127.0.0.1:26660`.  The clock it stamps snapshots and
successful polls with is `now_fn` (default time.time).
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from typing import Callable, Dict, List, Optional

from ..libs import tracemerge, tracing

POLL_TIMEOUT_S = 5.0  # per-RPC; a wedged node must not stall the sweep
STALL_MS = 3000.0  # part stream older than this and incomplete => alert


def _pctl(xs: List[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


class _NodeScope:
    """Per-node collector state: watermark, rolling event buffer, and the
    last successfully observed status/health."""

    __slots__ = (
        "target", "name", "since", "events", "anchor", "dropped", "alive",
        "last_err", "height", "health_ok", "polls", "failures", "last_ok_t",
    )

    def __init__(self, target: str):
        self.target = target
        self.name = target  # replaced by the node's moniker on first poll
        self.since = 0
        self.events: List[dict] = []
        self.anchor: Optional[dict] = None
        self.dropped = 0
        self.alive = False
        self.last_err = ""
        self.height: Optional[int] = None
        self.health_ok: Optional[bool] = None
        self.polls = 0
        self.failures = 0
        self.last_ok_t = 0.0


class Telescope:
    """The collector + dashboard.  `run()` drives poll sweeps forever (or
    for `cycles`); `last_snapshot` always holds the newest fleet view and
    is what the JSON endpoint serves.  `now_fn` is the wall clock (unix
    seconds) of `t_unix` and of each node's last good poll."""

    def __init__(
        self,
        targets: List[str],
        interval: float = 1.0,
        window: int = 5000,
        serve_addr: Optional[str] = None,
        stall_ms: float = STALL_MS,
        now_fn: Callable[[], float] = time.time,
    ):
        self.scopes = [_NodeScope(t) for t in targets]
        self.interval = interval
        self.window = window
        self.serve_addr = serve_addr
        self.stall_ms = stall_ms
        self.now_fn = now_fn
        self.last_snapshot: dict = {}
        self.bound_addr: Optional[str] = None
        self._http = None

    # -- polling ------------------------------------------------------------

    async def _poll_node(self, scope: _NodeScope) -> None:
        """One node, one sweep.  Each route is independently fallible —
        a node whose recorder route hangs still reports status, and a
        node that is flat-out dead just flips to DOWN while its buffered
        window keeps serving the merge."""
        from ..rpc.client import HTTPClient

        scope.polls += 1
        ok = False
        try:
            async with HTTPClient(scope.target, timeout=POLL_TIMEOUT_S) as c:
                try:
                    dump = await asyncio.wait_for(
                        c._call("dump_flight_recorder", {"since": scope.since}),
                        POLL_TIMEOUT_S,
                    )
                    if dump.get("node"):
                        scope.name = dump["node"]
                    if dump.get("anchor"):
                        scope.anchor = dump["anchor"]
                    scope.dropped = dump.get("dropped", scope.dropped)
                    scope.since = dump.get("next_seq", scope.since)
                    fresh = dump.get("events") or []
                    if fresh:
                        scope.events.extend(fresh)
                        if len(scope.events) > self.window:
                            del scope.events[: len(scope.events) - self.window]
                    ok = True
                except Exception as e:  # noqa: BLE001 — per-section degradation
                    scope.last_err = repr(e)
                try:
                    st = await asyncio.wait_for(c._call("status", {}), POLL_TIMEOUT_S)
                    scope.height = int(
                        st.get("sync_info", {}).get("latest_block_height", 0)
                    )
                    ok = True
                except Exception as e:  # noqa: BLE001
                    scope.last_err = repr(e)
                try:
                    hl = await asyncio.wait_for(c._call("health", {}), POLL_TIMEOUT_S)
                    scope.health_ok = bool(hl.get("ok", True)) if hl else True
                except Exception:  # noqa: BLE001 — health is optional garnish
                    pass
        except Exception as e:  # noqa: BLE001 — connect refused / node gone
            scope.last_err = repr(e)
        scope.alive = ok
        if ok:
            scope.last_ok_t = self.now_fn()
        else:
            scope.failures += 1

    async def poll_once(self) -> None:
        await asyncio.gather(*(self._poll_node(s) for s in self.scopes))

    # -- analysis -----------------------------------------------------------

    def _dumps(self) -> List[dict]:
        """Dump-shaped dicts from the buffered windows — dead nodes
        included while their buffer lasts, exactly so a SIGKILLed node's
        final seconds stay on the merged timeline."""
        out = []
        for s in self.scopes:
            if s.events and s.anchor:
                out.append(
                    {
                        "node": s.name,
                        "enabled": True,
                        "size": len(s.events),
                        "next_seq": s.since,
                        "dropped": s.dropped,
                        "anchor": dict(s.anchor),
                        "events": s.events,
                    }
                )
        return out

    def _stalled_parts(self, scope: _NodeScope) -> List[int]:
        """Heights whose part stream started (first proposal/part seen)
        but never completed within the stall window, judged against the
        node's own newest event time (monotonic, node-local)."""
        started: Dict[int, int] = {}
        done: Dict[int, int] = {}
        last_t = 0
        for ev in scope.events:
            t = ev.get("t_ns", 0)
            last_t = max(last_t, t)
            k = ev.get("kind")
            if k == "block.parts_complete":
                done.setdefault(ev.get("height"), t)
            elif k == "proposal":
                started.setdefault(ev.get("height"), t)
            elif k == "gossip.hop" and ev.get("frame") == "block_part":
                h = ev.get("h")
                if h is not None:
                    started.setdefault(h, t)
        return sorted(
            h
            for h, t in started.items()
            if h is not None
            and h not in done
            and (last_t - t) / 1e6 > self.stall_ms
        )

    def snapshot(self) -> dict:
        """One fleet view: per-node state, the live-merged timeline
        summary, and fleet health.  Every section degrades independently
        — a merge failure (e.g. one node's torn dump) is reported, not
        raised."""
        dumps = self._dumps()
        merged: Optional[dict] = None
        merge_err = ""
        if len(dumps) >= 2:
            try:
                merged = tracemerge.merge(dumps)
            except Exception as e:  # noqa: BLE001 — keep the board up
                merge_err = repr(e)

        heights = [s.height for s in self.scopes if s.height is not None]
        tip = max(heights) if heights else None
        fanin_p50: List[float] = []
        fanin_p90: List[float] = []
        hop_lat: List[float] = []
        clamped = 0
        stalled: Dict[str, List[int]] = {}
        nodes = []
        for s in self.scopes:
            budget = tracing.net_budget(s.events) if s.events else None
            if budget:
                vf = budget["stages"].get("vote_fanin")
                if vf:
                    fanin_p50.append(vf["p50_ms"])
                    fanin_p90.append(vf["p90_ms"])
                clamped += budget.get("clamped", 0)
            for ev in s.events:
                if ev.get("kind") == "gossip.hop" and ev.get("lat_ms") is not None:
                    hop_lat.append(ev["lat_ms"])
            st = self._stalled_parts(s)
            if st:
                stalled[s.name] = st
            entry = {
                "target": s.target,
                "name": s.name,
                "alive": s.alive,
                "height": s.height,
                "lag": (tip - s.height) if tip is not None and s.height is not None else None,
                "health_ok": s.health_ok,
                "events_buffered": len(s.events),
                "polls": s.polls,
                "failures": s.failures,
            }
            if not s.alive and s.last_err:
                entry["last_err"] = s.last_err
            if budget:
                entry["net_budget"] = budget
            nodes.append(entry)

        fleet: dict = {
            "alive": sum(1 for s in self.scopes if s.alive),
            "total": len(self.scopes),
            "tip": tip,
            "tip_spread": (tip - min(heights)) if len(heights) >= 2 else None,
            "clamped_trace_fields": clamped,
            "stalled_parts": stalled,
        }
        if fanin_p50:
            fleet["quorum_latency_ms"] = {
                "p50": round(_pctl(fanin_p50, 0.5), 3),
                "p90": round(_pctl(fanin_p90, 0.5), 3),
            }
        if hop_lat:
            fleet["hop_latency_ms"] = {
                "n": len(hop_lat),
                "p50": round(_pctl(hop_lat, 0.5), 3),
                "p90": round(_pctl(hop_lat, 0.9), 3),
            }

        snap: dict = {"t_unix": round(self.now_fn(), 3), "nodes": nodes, "fleet": fleet}
        if merged is not None:
            snap["merged"] = {
                "nodes": merged["nodes"],
                "offsets_ms": merged["offsets_ms"],
                "offset_samples": merged.get("offset_samples"),
                "offset_sources": merged.get("offset_sources"),
                "heights": sorted(merged["heights"]),
                "commit_skew_ms_p50": merged.get("commit_skew_ms_p50"),
                "commit_skew_ms_p90": merged.get("commit_skew_ms_p90"),
                "coverage_ms_p50": merged.get("coverage_ms_p50"),
                "coverage_ms_p90": merged.get("coverage_ms_p90"),
                "hash_mismatch_heights": merged.get("hash_mismatch_heights"),
            }
        elif merge_err:
            snap["merge_error"] = merge_err
        return snap

    # -- rendering ----------------------------------------------------------

    def render(self, snap: dict) -> str:
        fleet = snap["fleet"]
        lines = [
            f"fleet telescope  {time.strftime('%H:%M:%S', time.localtime(self.now_fn()))}  "
            f"{fleet['alive']}/{fleet['total']} up"
            + (f"  tip={fleet['tip']}" if fleet.get("tip") is not None else "")
            + (
                f"  spread={fleet['tip_spread']}"
                if fleet.get("tip_spread") is not None
                else ""
            ),
        ]
        ql = fleet.get("quorum_latency_ms")
        hl = fleet.get("hop_latency_ms")
        if ql or hl:
            parts = []
            if ql:
                parts.append(f"quorum p50/p90 {ql['p50']}/{ql['p90']} ms")
            if hl:
                parts.append(
                    f"hop lat p50/p90 {hl['p50']}/{hl['p90']} ms (n={hl['n']})"
                )
            if fleet.get("clamped_trace_fields"):
                parts.append(f"clamped={fleet['clamped_trace_fields']}")
            lines.append("  " + "  ".join(parts))
        merged = snap.get("merged")
        if merged:
            srcs = merged.get("offset_sources") or []
            ns = merged.get("offset_samples") or []
            offs = ", ".join(
                f"{n} {o:+.1f}ms({src or '?'} n={cnt})"
                for n, o, src, cnt in zip(
                    merged["nodes"], merged["offsets_ms"], srcs, ns
                )
            )
            lines.append(f"  skew: {offs}")
            if merged.get("commit_skew_ms_p50") is not None:
                lines.append(
                    f"  merged {len(merged['heights'])} heights; commit skew "
                    f"p50/p90 {merged['commit_skew_ms_p50']}/"
                    f"{merged['commit_skew_ms_p90']} ms"
                )
        elif snap.get("merge_error"):
            lines.append(f"  merge error: {snap['merge_error']}")
        lines.append("")
        lines.append(f"  {'node':<16}{'state':<7}{'height':>8}{'lag':>5}  quorum/hop (ms)")
        for n in snap["nodes"]:
            state = "UP" if n["alive"] else "DOWN"
            nb = n.get("net_budget") or {}
            vf = (nb.get("stages") or {}).get("vote_fanin")
            lat = (nb.get("hop_lat_ms") or {})
            hop_bits = " ".join(
                f"{k}={v['p50']}" for k, v in sorted(lat.items())
            )
            detail = (f"fanin p50 {vf['p50_ms']}  " if vf else "") + hop_bits
            lines.append(
                f"  {n['name'][:15]:<16}{state:<7}"
                f"{n['height'] if n['height'] is not None else '-':>8}"
                f"{n['lag'] if n['lag'] is not None else '-':>5}  {detail}"
            )
            if not n["alive"] and n.get("last_err"):
                lines.append(f"      last error: {n['last_err'][:90]}")
        stalled = fleet.get("stalled_parts") or {}
        for name, hs in sorted(stalled.items()):
            lines.append(f"  ALERT {name}: part stream stalled at heights {hs}")
        return "\n".join(lines)

    # -- serving ------------------------------------------------------------

    async def _route(self, req):
        from ..rpc import http

        if req.path != "/snapshot":
            return http.NOT_FOUND
        if req.method not in ("GET", "HEAD"):
            return http.NOT_ALLOWED
        return 200, json.dumps(self.last_snapshot, default=repr).encode(), http.JSON

    async def start_server(self) -> None:
        """JSON snapshot endpoint, modeled on libs/metrics.MetricsServer:
        the JAX endpoint's status, body and content type."""
        from ..rpc.http import HTTPServer

        server = HTTPServer(self._route, logger="telescope")
        try:
            self.bound_addr = await server.start(self.serve_addr)
        except OSError as e:
            raise OSError(
                f"telescope failed to bind {self.serve_addr!r}: {e}"
            ) from e
        self._http = server

    async def stop_server(self) -> None:
        server, self._http = self._http, None
        if server is not None:
            await server.stop()

    # -- driver -------------------------------------------------------------

    async def run(
        self,
        cycles: Optional[int] = None,
        dashboard: bool = True,
        json_lines: bool = False,
    ) -> dict:
        """Poll sweeps until `cycles` (None = forever), refreshing the
        dashboard (ANSI clear) or emitting one JSON line per sweep.  The
        newest snapshot is always retained in `last_snapshot`."""
        if self.serve_addr:
            await self.start_server()
        try:
            i = 0
            while cycles is None or i < cycles:
                await self.poll_once()
                self.last_snapshot = self.snapshot()
                if json_lines:
                    print(json.dumps(self.last_snapshot, default=repr), flush=True)
                elif dashboard:
                    sys.stdout.write(
                        "\x1b[2J\x1b[H" + self.render(self.last_snapshot) + "\n"
                    )
                    sys.stdout.flush()
                i += 1
                if cycles is None or i < cycles:
                    await asyncio.sleep(self.interval)
        finally:
            await self.stop_server()
        return self.last_snapshot


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="live fleet telescope over node flight recorders"
    )
    ap.add_argument("targets", help="comma-separated RPC laddrs (host:port,...)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--window", type=int, default=5000)
    ap.add_argument("--serve", default="")
    ap.add_argument("--cycles", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    tele = Telescope(
        [t for t in args.targets.split(",") if t],
        interval=args.interval,
        window=args.window,
        serve_addr=args.serve or None,
    )
    try:
        asyncio.run(
            tele.run(
                cycles=args.cycles if args.cycles > 0 else None,
                dashboard=not args.json,
                json_lines=args.json,
            )
        )
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
