"""Tx-ingress load generator, tm-bench parity (the port's copy of
tendermint_tpu/tools/loadgen.py, on the port's own HTTP/1.1 client where
the JAX one runs on aiohttp; the same tx bytes, classification and report
keys).

Drives signed-tx envelopes (mempool.make_signed_tx) at the JSON-RPC
broadcast endpoints across many concurrent connections at a configurable
rate/size, and reports the numbers the overload layer is judged by:

  - offered vs accepted vs rejected tx/sec (the acceptance split), with
    every rejection CLASSIFIED: `throttled` = explicit SERVER_OVERLOADED
    errors (rate limit / in-flight cap / mempool full — the admission
    contract), `rejected` = app- or mempool-level refusals, `transport` =
    connection errors/timeouts (silent drops; a healthy overloaded node
    should produce ~none);
  - commit-latency-under-load percentiles, measured from the TARGET
    node's flight recorder (`dump_flight_recorder` `step` events): the
    wall milliseconds between consecutive Commit steps while the firehose
    runs.

Each connection is one rpc.client.HTTPClient (a keep-alive HTTP/1.1
connection, opened again after a transport error); the commit monitor
reads the flight recorder by JSON-RPC.  `--mode bank` sends contended
signed transfers to one hot account (needs proxy_app = bank or staking).

Programmatic entry: `await run_load(targets, ...)`; CLI:

    python -m tendermint_tpu_torch.tools.loadgen 127.0.0.1:26657 \\
        --connections 8 --duration 10 --rate 1000 --tx-bytes 250 --mode sync --json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time
from typing import Dict, List, Optional

from ..crypto.keys import Ed25519PrivKey
from ..mempool import make_signed_tx
from ..rpc.client import HTTPClient
from ..rpc.jsonrpc import SERVER_OVERLOADED, RPCError

TRANSPORT_ERRORS = (ConnectionError, OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                    ValueError)


def percentiles(xs: List[float], ps=(50, 90, 99)) -> Dict[str, float]:
    if not xs:
        return {f"p{p}": -1.0 for p in ps}
    xs = sorted(xs)
    out = {}
    for p in ps:
        i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
        out[f"p{p}"] = round(xs[i], 1)
    return out


class Counters:
    __slots__ = ("offered", "accepted", "rejected", "throttled", "transport",
                 "retry_after_seen", "codes")

    def __init__(self):
        self.offered = 0
        self.accepted = 0
        self.rejected = 0
        self.throttled = 0
        self.transport = 0
        self.retry_after_seen = 0
        self.codes: Dict[str, int] = {}

    def as_dict(self) -> dict:
        return {
            "offered": self.offered,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "throttled": self.throttled,
            "transport_errors": self.transport,
            "retry_after_seen": self.retry_after_seen,
            "reject_codes": dict(self.codes),
        }


def make_tx(key: Ed25519PrivKey, worker: int, seq: int, tx_bytes: int,
            fee: int = 0, signed: bool = True) -> bytes:
    """A unique kvstore payload padded to ~tx_bytes, optionally carrying a
    fee:<n>: priority prefix, wrapped in a signed envelope."""
    prefix = b"fee:%d:" % fee if fee > 0 else b""
    head = prefix + b"ld%d.%d=" % (worker, seq)
    pad = max(1, tx_bytes - len(head) - (102 if signed else 0))
    payload = head + b"x" * pad
    return make_signed_tx(key, payload) if signed else payload


# All bank-mode workers credit ONE hot account: maximal write contention
# on a single balance while each sender keeps its own nonce lane.
_HOT_ACCOUNT = Ed25519PrivKey.from_secret(b"loadgen-hot-account").pub_key().address()

# 1-in-N bank txs deliberately overdraft, so the run exercises REAL
# app-level rejections (CODE_INSUFFICIENT_FUNDS) — not just happy-path
# accepts — and the classifier's app:<code> split is visibly non-empty.
_BANK_OVERDRAFT_EVERY = 50


def make_bank_tx(key: Ed25519PrivKey, seq: int, fee: int = 0) -> bytes:
    """A signed bank transfer to the shared hot account.  The overdraft
    probe sends an impossible amount on a schedule; its nonce is REUSED by
    the next real transfer (a rejected tx never burns a nonce)."""
    from ..apps.bank import make_transfer_tx

    nonce = seq - seq // _BANK_OVERDRAFT_EVERY if _BANK_OVERDRAFT_EVERY else seq
    if _BANK_OVERDRAFT_EVERY and seq % _BANK_OVERDRAFT_EVERY == _BANK_OVERDRAFT_EVERY - 1:
        return make_transfer_tx(key, _HOT_ACCOUNT, 1 << 62, nonce, fee=fee)
    return make_transfer_tx(key, _HOT_ACCOUNT, 1, nonce, fee=fee)


async def _bank_start_seq(client: HTTPClient, key: Ed25519PrivKey) -> int:
    """Resume a worker's nonce lane from the chain (abci_query path=nonce)
    so back-to-back loadgen runs against one chain keep accepting."""
    try:
        res = await client.abci_query("nonce", key.pub_key().address())
        nonce = int(((res or {}).get("response") or {}).get("value") or b"0")
    except (RPCError, TypeError, AttributeError, *TRANSPORT_ERRORS):
        return 0
    # invert nonce -> seq: every full overdraft period consumes one extra
    # seq without consuming a nonce
    if _BANK_OVERDRAFT_EVERY:
        return nonce + nonce // (_BANK_OVERDRAFT_EVERY - 1)
    return nonce


def worker_key(wid: int) -> Ed25519PrivKey:
    return Ed25519PrivKey.from_secret(b"loadgen-%d" % wid)


async def _worker(
    wid: int,
    targets: List[str],
    deadline: float,
    counters: Counters,
    mode: str,
    tx_bytes: int,
    per_worker_rate: float,
    fee: int,
    signed: bool,
    request_timeout: float,
) -> None:
    key = worker_key(wid)
    clients = {t: HTTPClient(t, timeout=request_timeout) for t in targets}
    bank = mode == "bank"
    method = "broadcast_tx_sync" if bank else f"broadcast_tx_{mode}"
    next_send = time.monotonic()
    try:
        seq = await _bank_start_seq(clients[targets[0]], key) if bank else 0
        while time.monotonic() < deadline:
            if per_worker_rate > 0:
                now = time.monotonic()
                if now < next_send:
                    await asyncio.sleep(next_send - now)
                next_send += 1.0 / per_worker_rate
            tx = (
                make_bank_tx(key, seq, fee=fee)
                if bank
                else make_tx(key, wid, seq, tx_bytes, fee=fee, signed=signed)
            )
            seq += 1
            client = clients[targets[seq % len(targets)]]
            counters.offered += 1
            try:
                res = await getattr(client, method)(tx)
            except RPCError as e:
                if e.code == SERVER_OVERLOADED:
                    counters.throttled += 1
                    if isinstance(e.data, dict) and "retry_after" in e.data:
                        counters.retry_after_seen += 1
                else:
                    counters.rejected += 1
                    counters.codes[str(e.code)] = counters.codes.get(str(e.code), 0) + 1
                continue
            except TRANSPORT_ERRORS:
                counters.transport += 1
                continue
            if res.get("code", 0) == 0:
                counters.accepted += 1
            else:
                counters.rejected += 1
                counters.codes[f"app:{res.get('code')}"] = (
                    counters.codes.get(f"app:{res.get('code')}", 0) + 1
                )
    finally:
        for client in clients.values():
            await client.close()


async def _commit_monitor(target: str, deadline: float, out: dict, timeout: float) -> None:
    """Poll one node's flight recorder for `step` events and keep the
    first Commit-step timestamp per height; consecutive-height deltas are
    the commit-latency-under-load samples."""
    since = 0
    commit_ns: Dict[int, int] = {}
    client = HTTPClient(target, timeout=timeout)
    try:
        while True:
            if time.monotonic() >= deadline:
                break
            try:
                snap = await client._call("dump_flight_recorder",
                                          {"since": since, "kinds": "step"}) or {}
                since = snap.get("next_seq", since)
                for ev in snap.get("events", []):
                    if ev.get("kind") == "step" and ev.get("step") == "Commit":
                        commit_ns.setdefault(ev["height"], ev["t_ns"])
            except (RPCError, *TRANSPORT_ERRORS):
                pass
            await asyncio.sleep(min(0.5, max(0.05, deadline - time.monotonic())))
    finally:
        await client.close()
    heights = sorted(commit_ns)
    out["heights"] = len(heights)
    out["intervals_ms"] = [
        (commit_ns[b] - commit_ns[a]) / 1e6
        for a, b in zip(heights, heights[1:])
        if b == a + 1
    ]


async def run_load(
    targets: List[str],
    duration: float = 10.0,
    rate: float = 0.0,
    connections: int = 8,
    tx_bytes: int = 192,
    mode: str = "sync",
    fee: int = 0,
    signed: bool = True,
    monitor_target: Optional[str] = None,
    request_timeout: float = 10.0,
) -> dict:
    """Fire the firehose; returns the acceptance split + latency report.
    `rate` is the TOTAL offered tx/sec across all connections (0 = as
    fast as the connections can go)."""
    counters = Counters()
    monitor: dict = {}
    deadline = time.monotonic() + duration
    tasks = [
        asyncio.ensure_future(_worker(
            i, targets, deadline, counters, mode, tx_bytes,
            rate / connections if rate > 0 else 0.0, fee, signed, request_timeout))
        for i in range(connections)
    ]
    tasks.append(asyncio.ensure_future(
        _commit_monitor(monitor_target or targets[0], deadline, monitor, request_timeout)))
    await asyncio.gather(*tasks)
    intervals = monitor.get("intervals_ms", [])
    return {
        "duration_s": round(duration, 2),
        "connections": connections,
        "mode": mode,
        "tx_bytes": tx_bytes,
        "offered_tps": round(counters.offered / duration, 1),
        "tx_ingress_sustained_tps": round(counters.accepted / duration, 1),
        "commit_latency_under_load_ms": percentiles(intervals),
        "commits_under_load": monitor.get("heights", 0),
        **counters.as_dict(),
    }


async def _lite_worker(
    i: int,
    target: str,
    deadline: float,
    trust_height: int,
    trust_hash: str,
    stats: dict,
    request_timeout: float,
):
    """One tenant: create a session at the shared trust root, then loop
    verified-commit queries over random heights in [root, the session's
    latest trusted height]."""
    rng = random.Random(0xC0FFEE ^ i)
    client = HTTPClient(target, timeout=request_timeout)
    try:
        try:
            res = await client._call("lite_session_new", {
                "trust_height": trust_height, "trust_hash": trust_hash,
            })
        except RPCError as e:
            stats["throttled" if e.code == SERVER_OVERLOADED else "rejected"] += 1
            return
        except TRANSPORT_ERRORS:
            stats["transport"] += 1
            return
        sid = res["session"]
        tip = res.get("latest_trusted_height") or trust_height
        served = 0
        while time.monotonic() < deadline:
            height = rng.randint(trust_height, max(trust_height, tip))
            t0 = time.monotonic()
            try:
                res = await client._call("lite_commit", {"session": sid, "height": height})
            except RPCError as e:
                if e.code == SERVER_OVERLOADED:
                    stats["throttled"] += 1
                    await asyncio.sleep(0.05)
                else:
                    stats["rejected"] += 1
                continue
            except TRANSPORT_ERRORS:
                stats["transport"] += 1
                continue
            served += 1
            stats["completed"] += 1
            stats["latencies_ms"].append((time.monotonic() - t0) * 1e3)
            # the tip stays the session's: the JAX tool reads a top-level
            # "height" that the signed header's JSON does not carry
        if served:
            stats["sustained"] += 1
    finally:
        await client.close()


async def run_lite_load(
    target: str,
    sessions: int = 64,
    duration: float = 10.0,
    trust_height: int = 1,
    trust_hash: str = "",
    request_timeout: float = 15.0,
) -> dict:
    """Drive `sessions` concurrent light-client tenants against a
    liteserve gateway; reports the bench keys the lite smoke is judged by
    (`lite_bisections_per_sec`, `lite_cache_hit_ratio`,
    `lite_verify_coalesce_ratio`, `lite_sessions_sustained`) — the ratios
    scraped from the gateway's own lite_status counters."""
    stats: dict = {
        "completed": 0, "throttled": 0, "rejected": 0, "transport": 0,
        "sustained": 0, "latencies_ms": [],
    }
    deadline = time.monotonic() + duration
    await asyncio.gather(*(
        _lite_worker(i, target, deadline, trust_height, trust_hash, stats, request_timeout)
        for i in range(sessions)
    ))
    client = HTTPClient(target, timeout=request_timeout)
    try:
        status = await client._call("lite_status", {})
    except Exception:  # noqa: BLE001 — report client-side numbers anyway
        status = {}
    finally:
        await client.close()
    verify = status.get("verify", {})
    return {
        "duration_s": round(duration, 2),
        "lite_sessions": sessions,
        "lite_sessions_sustained": stats["sustained"],
        "lite_bisections_per_sec": round(stats["completed"] / duration, 1),
        "lite_cache_hit_ratio": verify.get("hit_ratio", -1.0),
        "lite_verify_coalesce_ratio": verify.get("coalesce_ratio", -1.0),
        "lite_commit_latency_ms": percentiles(stats["latencies_ms"]),
        "lite_requests_completed": stats["completed"],
        "lite_throttled": stats["throttled"],
        "lite_rejected": stats["rejected"],
        "lite_transport_errors": stats["transport"],
        "lite_server_verify": verify,
        "lite_server_sessions": status.get("sessions", {}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("targets", help="comma-separated RPC addresses (host:port,...)")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="total offered tx/sec (0 = as fast as possible)")
    ap.add_argument("--connections", type=int, default=8)
    ap.add_argument("--tx-bytes", type=int, default=192)
    ap.add_argument("--mode", choices=["sync", "async", "bank"], default="sync",
                    help="broadcast flavor; 'bank' sends contended signed "
                         "transfers (needs proxy_app = bank or staking)")
    ap.add_argument("--fee", type=int, default=0,
                    help="fee:<n>: priority prefix on every payload")
    ap.add_argument("--plain", action="store_true",
                    help="send bare payloads instead of signed envelopes")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--lite", action="store_true",
                    help="drive a liteserve gateway instead of tx ingress")
    ap.add_argument("--sessions", type=int, default=64,
                    help="concurrent light-client sessions (--lite)")
    ap.add_argument("--trust-height", type=int, default=1,
                    help="shared trust-root height tenants bring (--lite)")
    ap.add_argument("--trust-hash", default="",
                    help="trust-root header hash, hex (--lite)")
    args = ap.parse_args(argv)

    if args.lite:
        result = asyncio.run(
            run_lite_load(
                args.targets.split(",")[0],
                sessions=args.sessions,
                duration=args.duration,
                trust_height=args.trust_height,
                trust_hash=args.trust_hash,
            )
        )
        if args.json:
            print(json.dumps(result))
        else:
            lat = result["lite_commit_latency_ms"]
            print(
                f"sessions {result['lite_sessions_sustained']}/"
                f"{result['lite_sessions']}  bisections "
                f"{result['lite_bisections_per_sec']}/s  hit-ratio "
                f"{result['lite_cache_hit_ratio']}  coalesce "
                f"{result['lite_verify_coalesce_ratio']}  latency p50 "
                f"{lat['p50']} ms / p99 {lat['p99']} ms"
            )
        return 0

    result = asyncio.run(
        run_load(
            [t for t in args.targets.split(",") if t],
            duration=args.duration,
            rate=args.rate,
            connections=args.connections,
            tx_bytes=args.tx_bytes,
            mode=args.mode,
            fee=args.fee,
            signed=not args.plain,
        )
    )
    if args.json:
        print(json.dumps(result))
    else:
        lat = result["commit_latency_under_load_ms"]
        print(
            f"offered {result['offered_tps']}/s  accepted "
            f"{result['tx_ingress_sustained_tps']}/s  throttled "
            f"{result['throttled']}  rejected {result['rejected']}  "
            f"transport {result['transport_errors']}  commit-latency p50 "
            f"{lat['p50']} ms / p90 {lat['p90']} ms over "
            f"{result['commits_under_load']} commits"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
