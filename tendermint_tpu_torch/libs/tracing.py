"""Flight recorder (the port's copy of tendermint_tpu/libs/tracing.py): an
always-on ring buffer of hot-path span events, the reports read from it,
and the crash-persistent spool that journals it to disk.

No reference counterpart — the reference's hot path (serial per-signature
verification) has nothing worth tracing; the batched verify pipeline on
the card (crypto/batch_verifier.py) and the consensus step machine do, and
Prometheus histograms alone cannot answer "what did block 1234 spend its
milliseconds on".  The recorder keeps the last N events (monotonic-clock
timestamped, fixed memory) so the `dump_flight_recorder` RPC route, the
`trace` CLI and the smoke run all read the SAME event stream production
telemetry comes from.

Event kinds currently emitted:

  consensus (consensus/state.py):
    step              height, round, step      every H/R/S transition
    proposal          height, round, src       proposal accepted; src is the
                                               delivering peer id prefix or
                                               "self" when we proposed
    block.parts_complete  height, round, parts, src   the proposal block
                                               fully assembled on this node
                                               (src delivered the last part)
    commit            height, txs, block       block finalized (hash prefix)
  verify engine (crypto/batch_verifier.py):
    verify.enqueue    pending                  vote entered the batcher
    verify.enqueue_batch  n, pending           whole vote_batch entered as one arrival
    verify.direct_batch   n                    pre-batched frame sent straight to the engine
    verify.flush      batch, wait_ms, quantum_ms   batcher coalesced a flush
    verify.dispatch   n, bucket, path, host_prep_ms, device_ms
    verify.bucket_compile  bucket, ms, ok      background kernel-library build done
    verify.chunked    selected, rtt_ms, prep_ms    RTT-probe decision
    verify.table      hit, n                   TableCache lookup
    verify.table_rebuild  set_key, validators, ms, ok   proactive table build done
  (each verify kind also carries `shards`, the cards it ran on: 1 here)
  gossip (consensus/reactor.py, event-driven path):
    gossip.wakeup     peer                     routine woken by an event (not the
                                               fallback sleep cap); HIGH-RATE —
                                               subject to trace_sample_high_rate
    gossip.votes      mode, n, bytes, peer     vote send: mode batch|single
    gossip.vote_batch_recv  n, dup, peer       decoded batch entered the verifier
                                               (n fresh votes, dup already-held)
    gossip.part_burst n, peer[, catchup]       block parts sent in one burst
    gossip.hop        frame, peer, origin, hop[, h, lat_ms, clamped]
                                               wire-level trace context decoded
                                               off a received frame (gossip
                                               version >= 3): per-kind
                                               propagation latency (sender send
                                               wall ns vs our wall ns) and the
                                               content hop count.  `clamped=1`
                                               marks byzantine/garbled fields
                                               (hop out of range, origin
                                               timestamp outside the ±60 s
                                               sanity window) — those carry no
                                               lat_ms and are excluded from
                                               skew estimation.  HIGH-RATE —
                                               subject to trace_sample_high_rate
                                               (net_budget consumes it)
  scheduler profiler (libs/loopprof.py, [instrumentation] loop_profiler):
    loop.lag          lag_ms                   scheduled-vs-actual probe wakeup
                                               delta, once per probe interval
    loop.busy         interval_ms, <category>_ms...   per-category on-CPU task
                                               time accounted this interval
                                               (consensus/gossip/p2p-conn/
                                               verify/mempool/rpc/other)
    loop.gc_pause     n, ms, max_ms            GC pauses accumulated this
                                               interval (gc.callbacks hooks)
    loop.queue        <name>=depth...          sampled queue depths (consensus
                                               receive, verify pending, mconn
                                               send, flush executor)
  statesync (statesync/syncer.py + reactor.py, bootstrap only):
    statesync.offer   height, format, chunks, result   snapshot offered to the app
    statesync.chunk   index, total, peer       chunk hash-verified + applied
    statesync.restore height, ms               app restored + checked vs verified header
    statesync.handover  height                 restored state handed to fastsync
  ingress (rpc/core.py + mempool.py, overload admission control):
    ingress.throttle  reason[, source]         a broadcast request was rejected
                                               with an explicit overload error
                                               (reason rate|inflight|
                                               mempool_full|commit_waiters);
                                               HIGH-RATE — subject to
                                               trace_sample_high_rate
    ingress.evict     n, priority, size        a full mempool evicted n
                                               lower-priority txs to admit one
                                               of the given priority
  evidence (evidence.py, accountability pipeline):
    evidence.add      height, hash             evidence verified into the pool
    evidence.commit   height, hash             evidence committed into a block

Events are flat dicts: {"seq", "t_ns", "kind", **fields}.  `t_ns` is
time.monotonic_ns() — deltas are meaningful, wall-clock is not — but the
recorder also carries a monotonic→wall ANCHOR (sampled at construction
and re-sampled on every snapshot) so recorders dumped from DIFFERENT
nodes can be aligned onto one wall timeline: wall(ev) = anchor.wall_ns +
(ev.t_ns - anchor.mono_ns).  libs/tracemerge.py is the consumer.

High-rate kinds (per-wakeup gossip events; ~700 connections can evict
the entire ring between commits) go through `record_sampled`: with
`[instrumentation] trace_sample_high_rate` = N only 1-in-N events is
stored, and the stored event carries `sampled=N` so consumers can
re-scale counts.  N=1 (default) preserves the record-everything behavior
small nets want.

Performance contract: `record` on a disabled recorder (or the module NOP)
is one attribute check; enabled it is one uncontended lock, one
monotonic_ns call, one tuple and one list store — well under a
microsecond (tests/test_tracing.py tripwires the budget).  Writers may be
the event loop, the flush executor or warmup threads concurrently; the
lock makes seq order equal timestamp order, which the span-chain
consumers rely on.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, List, Optional, Sequence


class NopRecorder:
    """Disabled-path recorder: accepts events and drops them."""

    enabled = False
    size = 0
    sample_high_rate = 1

    def record(self, kind: str, **fields) -> None:
        pass

    def record_sampled(self, kind: str, **fields) -> None:
        pass

    def events(self, since: int = 0, kinds=None) -> List[dict]:
        return []

    def snapshot(self, since: int = 0, kinds=None) -> dict:
        return {"enabled": False, "size": 0, "next_seq": 0, "events": []}


NOP = NopRecorder()


class FlightRecorder:
    """Fixed-size ring of span events; `enabled=False` degrades to the nop
    fast path while keeping one object type at every call site."""

    __slots__ = (
        "size", "enabled", "sample_high_rate", "_buf", "_seq", "_lock",
        "_sample_counts", "_wall_ns_fn", "anchor_mono_ns", "anchor_wall_ns",
    )

    def __init__(
        self,
        size: int = 8192,
        enabled: bool = True,
        sample_high_rate: int = 1,
        wall_ns_fn: Callable[[], int] = time.time_ns,
    ):
        if size < 1:
            raise ValueError("flight recorder size must be >= 1")
        if sample_high_rate < 1:
            raise ValueError("trace_sample_high_rate must be >= 1")
        self.size = size
        self.enabled = enabled
        self.sample_high_rate = sample_high_rate
        self._buf: List[Optional[tuple]] = [None] * size
        self._seq = 0  # next sequence number; monotonic, never wraps
        # an uncontended Lock costs ~0.1 µs and guarantees seq order ==
        # timestamp order across writer threads (the monotonicity the
        # span-chain consumers rely on)
        self._lock = threading.Lock()
        self._sample_counts: dict = {}
        # monotonic→wall anchor: lets tracemerge place this recorder's
        # t_ns events on a wall timeline shared with OTHER nodes' dumps.
        # wall_ns_fn is pluggable so a skewed clock (in tests) can skew
        # what this node believes wall time is.
        self._wall_ns_fn = wall_ns_fn
        self.anchor_mono_ns = time.monotonic_ns()
        self.anchor_wall_ns = wall_ns_fn()

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        with self._lock:
            i = self._seq
            self._seq = i + 1
            self._buf[i % self.size] = (i, time.monotonic_ns(), kind, fields)

    def record_sampled(self, kind: str, **fields) -> None:
        """1-in-N recording for high-rate kinds (gossip.wakeup fires per
        wakeup — at committee scale it can evict the whole ring between
        commits).  The stored event carries `sampled=N` so consumers can
        re-scale counts; N=1 is a plain record (small-net default)."""
        if not self.enabled:
            return
        n = self.sample_high_rate
        if n <= 1:
            self.record(kind, **fields)
            return
        with self._lock:
            c = self._sample_counts.get(kind, 0) + 1
            self._sample_counts[kind] = 0 if c >= n else c
            if c != 1:  # store the 1st of every N
                return
            fields["sampled"] = n
            i = self._seq
            self._seq = i + 1
            self._buf[i % self.size] = (i, time.monotonic_ns(), kind, fields)

    def events(self, since: int = 0, kinds: Optional[Sequence[str]] = None) -> List[dict]:
        """Events still in the ring with seq >= since, oldest first.
        `kinds` filters by prefix match (["gossip.", "step"] keeps every
        gossip event and the step transitions)."""
        out = []
        pref = tuple(kinds) if kinds else None
        for ev in self._buf:
            if ev is not None and ev[0] >= since:
                if pref is not None and not ev[2].startswith(pref):
                    continue
                out.append(ev)
        out.sort(key=lambda ev: ev[0])
        return [
            {"seq": seq, "t_ns": t_ns, "kind": kind, **fields}
            for seq, t_ns, kind, fields in out
        ]

    def snapshot(self, since: int = 0, kinds: Optional[Sequence[str]] = None) -> dict:
        """The dump_flight_recorder RPC payload.  `next_seq` lets a poller
        pass it back as `since` to stream only fresh events; dropped =
        events that aged out of the ring before this snapshot.  `anchor`
        is RE-SAMPLED here (monotonic and wall read back-to-back) so a
        long-lived node's dump carries a fresh mapping — NTP slew between
        start and dump would otherwise skew cross-node alignment."""
        events = self.events(since, kinds)
        mono = time.monotonic_ns()
        wall = self._wall_ns_fn()
        return {
            "enabled": self.enabled,
            "size": self.size,
            "next_seq": self._seq,
            "since": since,
            "dropped": max(0, self._seq - self.size),
            "anchor": {"mono_ns": mono, "wall_ns": wall},
            "events": events,
        }

    @property
    def dropped(self) -> int:
        """Events that have aged out of the ring since start — the silent-
        span-loss number `tendermint_recorder_dropped_total` exports and
        `trace --check` warns about."""
        return max(0, self._seq - self.size)


def step_chains(events: List[dict]) -> dict:
    """Group `step` events into per-height chains: {height: {step_name:
    first_t_ns}}.  The shared consumer for the smoke run's breakdown, the
    `trace --check` gate and the CLI — one definition of "a block's span
    chain" everywhere."""
    chains: dict = {}
    for ev in events:
        if ev.get("kind") != "step":
            continue
        chains.setdefault(ev["height"], {}).setdefault(ev["step"], ev["t_ns"])
    return chains


#: The steps every committed height must pass through, in order.  Wait
#: steps (PrevoteWait/PrecommitWait) and extra rounds are optional.
REQUIRED_STEPS = ("Propose", "Prevote", "Precommit", "Commit")


def complete_heights(chains: dict) -> List[int]:
    """Heights with a full propose→commit chain, ascending."""
    return sorted(
        h for h, steps in chains.items() if all(s in steps for s in REQUIRED_STEPS)
    )


def span_report(events: List[dict], dropped: int = 0, since: int = 0) -> dict:
    """Classify every interior recorded height's span chain:

      complete   — full propose→commit chain present
      truncated  — missing steps are exactly a PREFIX of the required
                   chain while the ring wrapped (dropped > 0) or the dump
                   was watermarked (since > 0): eviction is strictly
                   oldest-first, so a busy ring legitimately ages out the
                   EARLY steps of a height whose commit is still fresh.
                   Not a failure — `trace --check` used to hard-fail here,
                   which made it useless exactly on the busy nets it is
                   for.
      bad        — {height: missing_steps} with a mid-chain or suffix
                   hole: a LATER step present while an earlier one is
                   missing cannot be eviction (later events are newer) and
                   is a real instrumentation/consensus bug.

    Edge heights (first/last recorded) are excluded as before — startup
    and the dump instant truncate them trivially."""
    chains = step_chains(events)
    heights = sorted(chains)
    interior = heights[1:-1]
    wrapped = (dropped or 0) > 0 or (since or 0) > 0
    complete: List[int] = []
    truncated: List[int] = []
    bad: dict = {}
    for h in interior:
        steps = chains[h]
        missing = [s for s in REQUIRED_STEPS if s not in steps]
        if not missing:
            complete.append(h)
        elif wrapped and tuple(missing) == REQUIRED_STEPS[: len(missing)]:
            truncated.append(h)
        else:
            bad[h] = missing
    return {"complete": complete, "truncated": truncated, "bad": bad,
            "interior": len(interior)}


def block_breakdown(events: List[dict]) -> Optional[dict]:
    """Median per-step milliseconds across every complete span chain in
    the event stream: how long each height sat in Propose / Prevote /
    Precommit, commit→next-height turnaround, and total block time
    (propose(h) → propose(h+1)).  None when fewer than 2 complete,
    consecutive chains exist."""
    chains = step_chains(events)
    heights = complete_heights(chains)
    propose_ms, prevote_ms, precommit_ms, commit_ms, block_ms = [], [], [], [], []
    for h in heights:
        steps = chains[h]
        propose_ms.append((steps["Prevote"] - steps["Propose"]) / 1e6)
        prevote_ms.append((steps["Precommit"] - steps["Prevote"]) / 1e6)
        precommit_ms.append((steps["Commit"] - steps["Precommit"]) / 1e6)
        nxt = chains.get(h + 1)
        if nxt and "Propose" in nxt:
            commit_ms.append((nxt["Propose"] - steps["Commit"]) / 1e6)
            block_ms.append((nxt["Propose"] - steps["Propose"]) / 1e6)
    if not block_ms:
        return None

    def med(xs: List[float]) -> float:
        xs = sorted(xs)
        return xs[len(xs) // 2]

    return {
        "source": "flight_recorder",
        "blocks": len(block_ms),
        "propose_ms": round(med(propose_ms), 3),
        "prevote_ms": round(med(prevote_ms), 3),
        "precommit_ms": round(med(precommit_ms), 3),
        "commit_ms": round(med(commit_ms), 3),
        "block_ms": round(med(block_ms), 3),
    }


#: Stage names of the consensus latency budget, in pipeline order.
#: commit_persist = enter Commit → delivery handoff (block save + WAL
#: ENDHEIGHT); finalize = the ABCI delivery span (begin/deliver_tx/end/
#: commit + events), which overlaps the next height when the pipeline is
#: on; next_propose = Commit(H) → Propose(H+1), the height turnaround.
BUDGET_STAGES = (
    "propose", "prevote", "precommit", "commit_persist", "finalize", "next_propose",
)


def _pctl(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (sorted copy; 0 on empty)."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def stage_budget(events: List[dict]) -> Optional[dict]:
    """Decompose committed heights into a per-stage latency budget from
    flight-recorder spans: propose→prevote→precommit→commit(persist)→
    finalize(deliver)→next-propose, plus commit-to-commit percentiles —
    the `trace budget` report (per-stage methodology after
    arXiv:2302.00418 §5).  Uses the `step` chains for the vote stages and
    the `deliver.start`/`deliver.end` span for ABCI delivery, so the same
    report attributes time in both serial and pipelined modes.  None when
    fewer than 2 complete consecutive chains exist."""
    chains = step_chains(events)
    heights = complete_heights(chains)
    deliver_start: dict = {}
    deliver_end: dict = {}
    for ev in events:
        k = ev.get("kind")
        if k == "deliver.start":
            deliver_start.setdefault(ev["height"], ev["t_ns"])
        elif k == "deliver.end":
            deliver_end[ev["height"]] = ev["t_ns"]
    stages: dict = {name: [] for name in BUDGET_STAGES}
    c2c: List[float] = []
    for h in heights:
        steps = chains[h]
        stages["propose"].append((steps["Prevote"] - steps["Propose"]) / 1e6)
        stages["prevote"].append((steps["Precommit"] - steps["Prevote"]) / 1e6)
        stages["precommit"].append((steps["Commit"] - steps["Precommit"]) / 1e6)
        ds, de = deliver_start.get(h), deliver_end.get(h)
        if ds is not None:
            stages["commit_persist"].append((ds - steps["Commit"]) / 1e6)
            if de is not None:
                stages["finalize"].append((de - ds) / 1e6)
        nxt = chains.get(h + 1)
        if nxt and "Propose" in nxt:
            stages["next_propose"].append((nxt["Propose"] - steps["Commit"]) / 1e6)
        if nxt and "Commit" in nxt:
            c2c.append((nxt["Commit"] - steps["Commit"]) / 1e6)
    if not c2c:
        return None
    out: dict = {"source": "flight_recorder", "blocks": len(c2c), "stages": {}}
    for name in BUDGET_STAGES:
        xs = stages[name]
        if xs:
            out["stages"][name] = {
                "n": len(xs),
                "p50_ms": round(_pctl(xs, 0.5), 3),
                "p90_ms": round(_pctl(xs, 0.9), 3),
                "max_ms": round(max(xs), 3),
            }
    out["commit_to_commit_p50_ms"] = round(_pctl(c2c, 0.5), 3)
    out["commit_to_commit_p90_ms"] = round(_pctl(c2c, 0.9), 3)
    return out


def format_budget(budget: Optional[dict]) -> str:
    """Aligned table rendering of a stage_budget dict (`trace --budget`)."""
    if budget is None:
        return "no complete consecutive span chains — nothing to budget"
    lines = [
        f"latency budget over {budget['blocks']} blocks  "
        f"(commit-to-commit p50 {budget['commit_to_commit_p50_ms']} ms, "
        f"p90 {budget['commit_to_commit_p90_ms']} ms)",
        f"  {'stage':<15}{'n':>5}{'p50 ms':>10}{'p90 ms':>10}{'max ms':>10}",
    ]
    for name in BUDGET_STAGES:
        st = budget["stages"].get(name)
        if st is None:
            continue
        lines.append(
            f"  {name:<15}{st['n']:>5}{st['p50_ms']:>10.3f}"
            f"{st['p90_ms']:>10.3f}{st['max_ms']:>10.3f}"
        )
    return "\n".join(lines)


#: Stage names of the cross-node network budget, in dissemination order.
#: proposal_prop = wire propagation latency of received proposal frames
#: (origin send stamp → our receive, measured — needs gossip_version 3
#: peers); part_stream = first sign of the block (proposal accepted or
#: first part hop) → part set complete; vote_fanin = first vote activity
#: for the height (Prevote entry or first vote_batch received) → Commit
#: entry (+2/3 precommits held).
NET_BUDGET_STAGES = ("proposal_prop", "part_stream", "vote_fanin")


def net_budget(events: List[dict]) -> Optional[dict]:
    """The cross-node sibling of stage_budget: from ONE node's flight
    recorder alone, attribute where inter-node time goes per height —
    proposal propagation, part-stream completion, vote fan-in to quorum —
    plus per-frame-kind hop-count and propagation-latency distributions
    from the wire-level trace context (`gossip.hop`, gossip_version >= 3).
    The budget stages work on any net (they only need step/proposal/
    parts_complete events); the hop/latency sections need traced peers.
    Surfaced as `trace --net-budget` and read by the telescope.  None when no height has enough events for any stage."""
    chains = step_chains(events)
    proposal_t: dict = {}        # height -> first proposal-accepted t_ns
    parts_done_t: dict = {}      # height -> parts_complete t_ns
    first_part_t: dict = {}      # height -> first block_part hop t_ns
    first_batch_t: dict = {}     # height -> first vote_batch_recv t_ns
    hops: dict = {}              # frame kind -> [hop counts]
    hop_lat: dict = {}           # frame kind -> [lat_ms]
    prop_lat: dict = {}          # height -> [proposal-frame lat_ms]
    clamped = 0
    for ev in events:
        k = ev.get("kind")
        if k == "proposal":
            proposal_t.setdefault(ev["height"], ev["t_ns"])
        elif k == "block.parts_complete":
            parts_done_t.setdefault(ev["height"], ev["t_ns"])
        elif k == "gossip.vote_batch_recv":
            h = ev.get("h")
            if h is not None:
                first_batch_t.setdefault(h, ev["t_ns"])
        elif k == "gossip.hop":
            frame = ev.get("frame", "?")
            if ev.get("clamped"):
                clamped += 1
            else:
                hops.setdefault(frame, []).append(ev.get("hop", 0))
                lat = ev.get("lat_ms")
                if lat is not None:
                    hop_lat.setdefault(frame, []).append(lat)
                    if frame == "proposal" and ev.get("h") is not None:
                        prop_lat.setdefault(ev["h"], []).append(lat)
            if frame == "block_part" and ev.get("h") is not None:
                first_part_t.setdefault(ev["h"], ev["t_ns"])
    stages: dict = {name: [] for name in NET_BUDGET_STAGES}
    heights: List[int] = []
    for h in sorted(set(chains) | set(parts_done_t) | set(prop_lat)):
        used = False
        for lat in prop_lat.get(h, ()):
            stages["proposal_prop"].append(lat)
            used = True
        done = parts_done_t.get(h)
        if done is not None:
            starts = [t for t in (proposal_t.get(h), first_part_t.get(h)) if t is not None]
            if starts and done >= min(starts):
                stages["part_stream"].append((done - min(starts)) / 1e6)
                used = True
        steps = chains.get(h, {})
        quorum = steps.get("Commit")
        if quorum is not None:
            starts = [t for t in (steps.get("Prevote"), first_batch_t.get(h)) if t is not None]
            if starts and quorum >= min(starts):
                stages["vote_fanin"].append((quorum - min(starts)) / 1e6)
                used = True
        if used:
            heights.append(h)
    if not heights and not hops:
        return None

    def dist(xs: List[float]) -> dict:
        return {
            "n": len(xs),
            "p50": round(_pctl(xs, 0.5), 3),
            "p90": round(_pctl(xs, 0.9), 3),
            "max": round(max(xs), 3) if xs else 0.0,
        }

    out: dict = {
        "source": "flight_recorder",
        "blocks": len(heights),
        "heights": [heights[0], heights[-1]] if heights else [],
        "stages": {},
        "hops": {},
        "hop_lat_ms": {},
        "clamped": clamped,
    }
    for name in NET_BUDGET_STAGES:
        xs = stages[name]
        if xs:
            d = dist(xs)
            out["stages"][name] = {
                "n": d["n"], "p50_ms": d["p50"], "p90_ms": d["p90"], "max_ms": d["max"],
            }
    for frame, xs in sorted(hops.items()):
        out["hops"][frame] = dist([float(x) for x in xs])
    for frame, xs in sorted(hop_lat.items()):
        out["hop_lat_ms"][frame] = dist(xs)
    pooled = [x for xs in hop_lat.values() for x in xs]
    if pooled:
        # frame-agnostic propagation latency: the telescope's fleet
        # hop-latency line
        out["hop_lat_all_ms"] = dist(pooled)
    return out


def format_net_budget(budget: Optional[dict]) -> str:
    """Aligned rendering of a net_budget dict (`trace --net-budget`)."""
    if budget is None:
        return "no network-plane events — nothing to budget"
    span = (
        f" (heights {budget['heights'][0]}..{budget['heights'][1]})"
        if budget.get("heights") else ""
    )
    lines = [
        f"network budget over {budget['blocks']} blocks{span}",
        f"  {'stage':<15}{'n':>5}{'p50 ms':>10}{'p90 ms':>10}{'max ms':>10}",
    ]
    for name in NET_BUDGET_STAGES:
        st = budget["stages"].get(name)
        if st is None:
            continue
        lines.append(
            f"  {name:<15}{st['n']:>5}{st['p50_ms']:>10.3f}"
            f"{st['p90_ms']:>10.3f}{st['max_ms']:>10.3f}"
        )
    if budget["hops"]:
        lines.append(f"  {'hop counts':<15}{'n':>5}{'p50':>10}{'p90':>10}{'max':>10}")
        for frame, d in budget["hops"].items():
            lines.append(
                f"  {frame:<15}{d['n']:>5}{d['p50']:>10.1f}{d['p90']:>10.1f}{d['max']:>10.1f}"
            )
    if budget["hop_lat_ms"]:
        lines.append(f"  {'hop lat ms':<15}{'n':>5}{'p50':>10}{'p90':>10}{'max':>10}")
        for frame, d in budget["hop_lat_ms"].items():
            lines.append(
                f"  {frame:<15}{d['n']:>5}{d['p50']:>10.3f}{d['p90']:>10.3f}{d['max']:>10.3f}"
            )
        d = budget.get("hop_lat_all_ms")
        if d:
            lines.append(
                f"  {'(all frames)':<15}{d['n']:>5}{d['p50']:>10.3f}"
                f"{d['p90']:>10.3f}{d['max']:>10.3f}"
            )
    if budget.get("clamped"):
        lines.append(f"  clamped trace fields: {budget['clamped']} (excluded above)")
    return "\n".join(lines)


#: The statesync bootstrap chain every snapshot restore must record, in
#: order.
STATESYNC_CHAIN = ("statesync.offer", "statesync.chunk", "statesync.restore", "statesync.handover")


def statesync_bootstrap_ms(events: List[dict]) -> Optional[float]:
    """Wall milliseconds from the (first) snapshot offer to the fastsync
    handover, measured from real recorder spans — the number the smoke run
    reports as `statesync_bootstrap_ms`.  None unless the full
    offer→chunk→restore→handover chain is present in order."""
    first: dict = {}
    last: dict = {}
    for ev in events:
        k = ev.get("kind")
        if k in STATESYNC_CHAIN:
            first.setdefault(k, ev["t_ns"])
            last[k] = ev["t_ns"]
    if any(k not in first for k in STATESYNC_CHAIN):
        return None
    o, c, r, h = (first[STATESYNC_CHAIN[0]], first[STATESYNC_CHAIN[1]],
                  last[STATESYNC_CHAIN[2]], last[STATESYNC_CHAIN[3]])
    if not (o <= c <= r <= h):
        return None
    return (h - o) / 1e6


# -- crash-persistent flight spool ------------------------------------------


class FlightSpool:
    """Crash-persistent sink for a FlightRecorder: an append-only rotating
    on-disk journal ([instrumentation] flight_spool) so a SIGKILLed, OOMed
    or wedged node leaves its last seconds of span events on disk.

    Discipline mirrors the mempool tx WAL (libs/autofile.Group): a head
    file plus rotated chunks, total size bounded by `size_limit` (oldest
    chunks deleted first — eviction is oldest-first, exactly like the
    in-memory ring, so `span_report`'s prefix-truncation tolerance applies
    to spool replays too).  Records are JSON lines:

        {"type": "anchor", "mono_ns", "wall_ns", "node", "lost"}   per flush
        {"seq", "t_ns", "kind", ...fields}                         per event

    The anchor line is re-sampled every flush so an offline replay carries
    a fresh monotonic→wall mapping for tracemerge alignment; `lost` counts
    events that aged out of the RING between flushes (the spool's own
    watermark fell behind) — honest about what the disk copy is missing.

    Crucially NOTHING here runs on the recording hot path: `record()` is
    untouched, the spool reads the ring from a flush cadence (the node's
    spool task), from the excepthook/atexit crash hooks, and from close().
    A SIGKILL cannot be caught — for it, the periodic cadence is the
    guarantee: everything up to the last flush (≤ flush_interval old)
    survives.  Flush is threadsafe (task + atexit may race).

    `run_id` tags this session's anchors (hex; default four bytes of
    os.urandom, as the JAX spool draws them) so a caller can make the
    spool's bytes reproducible."""

    def __init__(
        self,
        path: str,
        recorder: FlightRecorder,
        size_limit: int = 4 * 1024 * 1024,
        node: str = "",
        run_id: Optional[str] = None,
    ):
        from .autofile import Group

        self.recorder = recorder
        self.node = node
        self._group = Group(
            path,
            head_size_limit=max(4096, size_limit // 4),
            group_size_limit=size_limit,
        )
        self._watermark = 0  # next recorder seq to spool
        self._lock = threading.Lock()
        self._closed = False
        self._hooks_installed = False
        self._prev_excepthook = None
        self._hook_fn = None
        # run id: the spool file survives restarts (append-mode head) but
        # recorder seqs restart at 0 per process — without a per-run tag
        # the replay's seq-dedup would keep the OLD run's events and
        # present the previous run as the pre-crash evidence
        self.run_id = os.urandom(4).hex() if run_id is None else run_id
        self.flushes = 0
        self.spooled = 0
        self.lost = 0  # ring-wrap losses between flushes, cumulative

    def flush(self, sync: bool = False) -> int:
        """Append every ring event past the watermark; returns the number
        written.  `sync=True` adds an fsync (crash hooks / close)."""
        with self._lock:
            if self._closed:
                return 0
            events = self.recorder.events(since=self._watermark)
            lost = 0
            if events and events[0]["seq"] > self._watermark and self._watermark > 0:
                lost = events[0]["seq"] - self._watermark
            elif not events:
                # ring may have wrapped past the watermark with everything
                # already evicted (huge burst between flushes)
                lost = max(0, self.recorder._seq - self.recorder.size - self._watermark)
                if lost == 0 and self.recorder._seq == self._watermark:
                    return 0  # nothing new; skip the anchor line too
            self.lost += lost
            lines = [
                json.dumps(
                    {
                        "type": "anchor",
                        "run": self.run_id,
                        "mono_ns": time.monotonic_ns(),
                        "wall_ns": self.recorder._wall_ns_fn(),
                        "node": self.node,
                        "lost": self.lost,
                    },
                    separators=(",", ":"),
                )
            ]
            for ev in events:
                lines.append(json.dumps(ev, separators=(",", ":"), default=repr))
            self._group.write(("\n".join(lines) + "\n").encode())
            if sync:
                self._group.sync()
            else:
                self._group.flush()
            self._group.maybe_rotate()
            # enforce the size cap on EVERY flush, not only at rotation:
            # Group defers enforcement to rotate(), which lets the total
            # overshoot by up to a head file between rotations — the
            # spool's contract is a hard disk bound
            self._group._enforce_group_limit()
            if events:
                self._watermark = events[-1]["seq"] + 1
            else:
                self._watermark = self.recorder._seq
            self.flushes += 1
            self.spooled += len(events)
            return len(events)

    def install_crash_hooks(self) -> None:
        """Flush on interpreter exit and on an unhandled exception — the
        crash classes a periodic task never gets to run for.  (SIGINT/
        SIGTERM go through node.stop → close(); SIGKILL is covered only by
        the cadence.)"""
        if self._hooks_installed:
            return
        import atexit
        import sys

        atexit.register(self._crash_flush)
        self._prev_excepthook = sys.excepthook

        def hook(exc_type, exc, tb):
            self._crash_flush()
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = hook
        self._hook_fn = hook
        self._hooks_installed = True

    def remove_crash_hooks(self) -> None:
        if not self._hooks_installed:
            return
        import atexit
        import sys

        atexit.unregister(self._crash_flush)
        # restore only if OUR hook object is still installed — another
        # spool's hook (in-proc multi-node) or anything chained on top
        # must not be uninstalled out from under its owner
        if sys.excepthook is self._hook_fn and self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        self._hooks_installed = False

    def _crash_flush(self) -> None:
        try:
            self.flush(sync=True)
        except Exception:  # noqa: BLE001 — never mask the original crash
            pass

    def close(self) -> None:
        self.flush(sync=True)
        with self._lock:
            self._closed = True
            self._group.close()
        self.remove_crash_hooks()


def spool_paths(head_path: str) -> List[str]:
    """Rotated chunks (oldest first) + head — the on-disk read order for a
    spool at `head_path`.  Standalone (no Group): reading a dead node's
    spool must not open-for-append or touch the files."""
    d = os.path.dirname(head_path) or "."
    base = os.path.basename(head_path)
    pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
    chunks = []
    try:
        for name in os.listdir(d):
            m = pat.match(name)
            if m:
                chunks.append((int(m.group(1)), os.path.join(d, name)))
    except FileNotFoundError:
        return []
    out = [p for _, p in sorted(chunks)]
    if os.path.exists(head_path):
        out.append(head_path)
    return out


def read_spool(path: str, name: str = "") -> dict:
    """Offline spool replay → a dump-shaped dict (the same shape
    `dump_flight_recorder` serves), so tracemerge / span_report / `debug
    dump` work on a DEAD node's disk exactly like on a live node's RPC.

    Torn-tail tolerant: a process killed mid-append leaves a partial (or
    otherwise undecodable) final line — it is skipped and counted in
    `torn`, and every decodable record before it is kept, the same
    retained-suffix discipline as the mempool WAL replay.  `dropped`
    reports events known to be missing from the replay (ring-wrap losses
    recorded by the writer, rotated-away chunks, torn lines) so
    span_report can classify prefix-truncated heights honestly.

    The spool file survives restarts while recorder seqs restart at 0 per
    process, so anchors carry a per-spool-session `run` id and the replay
    SEGREGATES runs, returning the NEWEST (the crash under investigation —
    earlier runs' events would otherwise collide on seq and replace the
    evidence with stale data); `runs` reports how many sessions the file
    holds."""
    # per-run collection, runs in first-appearance (= file/time) order
    run_events: "dict[str, dict]" = {}  # run -> {"events": {seq: ev}, "anchor", "node", "lost"}
    run_order: List[str] = []
    current: Optional[str] = None
    pending: List[dict] = []  # events before the first surviving anchor
    torn = 0

    def _bucket(run: str) -> dict:
        if run not in run_events:
            run_events[run] = {"events": {}, "anchor": None, "node": "", "lost": 0}
            run_order.append(run)
        return run_events[run]

    for p in spool_paths(path):
        try:
            with open(p, "rb") as fh:
                data = fh.read()
        except OSError:
            continue
        for raw in data.split(b"\n"):
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except (ValueError, UnicodeDecodeError):
                torn += 1
                continue
            if not isinstance(rec, dict):
                torn += 1
                continue
            if rec.get("type") == "anchor":
                current = str(rec.get("run", ""))
                b = _bucket(current)
                b["anchor"] = {"mono_ns": rec.get("mono_ns", 0),
                               "wall_ns": rec.get("wall_ns", 0)}
                b["node"] = rec.get("node") or b["node"]
                b["lost"] = max(b["lost"], int(rec.get("lost", 0) or 0))
                if pending:
                    # events whose own anchor was rotated away belong to
                    # the run of the FIRST surviving anchor (each flush
                    # batch is anchor-first, so only a truncated batch
                    # head lands here)
                    for ev in pending:
                        b["events"].setdefault(ev["seq"], ev)
                    pending = []
            elif "seq" in rec and "kind" in rec:
                if current is None:
                    pending.append(rec)
                else:
                    run_events[current]["events"].setdefault(rec["seq"], rec)
            else:
                torn += 1
    if pending and not run_order:
        _bucket("")["events"].update({ev["seq"]: ev for ev in pending})
    # the NEWEST run is the one being investigated
    chosen = run_events[run_order[-1]] if run_order else {
        "events": {}, "anchor": None, "node": "", "lost": 0}
    events = sorted(chosen["events"].values(), key=lambda ev: ev["seq"])
    anchor, node, lost = chosen["anchor"], chosen["node"], chosen["lost"]
    # seq holes in the replay cover every loss class at once: events never
    # spooled (ring wrap — the writer's `lost` counter), rotated-away
    # chunks, and pre-spool ring history; `first` is the evicted prefix
    gaps = 0
    for a, b in zip(events, events[1:]):
        gaps += max(0, b["seq"] - a["seq"] - 1)
    first = events[0]["seq"] if events else 0
    return {
        "enabled": True,
        "source": "spool",
        "node": name or node or os.path.splitext(os.path.basename(path))[0],
        "size": len(events),
        "next_seq": (events[-1]["seq"] + 1) if events else 0,
        "since": 0,
        "dropped": first + gaps + torn,
        "torn": torn,
        "writer_lost": lost,
        "runs": len(run_order),
        "anchor": anchor,
        "events": events,
    }
