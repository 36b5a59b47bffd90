"""Cross-node causal trace merging (the port's copy of
tendermint_tpu/libs/tracemerge.py): N flight-recorder dumps → one
network-wide per-height timeline plus per-node loop attribution.

No reference counterpart — the reference debugs multi-node nets with logs
and a Jepsen harness; here every node already records monotonic span
events (libs/tracing.py) and each dump carries a monotonic→wall ANCHOR,
so the dumps from a whole committee can be placed on one wall timeline
and a 60-second block can be decomposed into *measured* phases:

    proposal born (src="self" on the proposer)
      → block-part coverage p50/p90 across nodes (block.parts_complete)
      → per-node prevote/precommit maj23 (step Precommit/Commit entries)
      → per-node commit + commit skew (commit events, cross-checked by
        block hash)

plus, per node, the scheduler profiler's attribution of each block
interval (libs/loopprof.attribution: task categories / GC / loop lag /
idle shares).  This is what `trace-net`, `debug watch` (tools/telescope.py)
and the smoke run's phase 16 all run.

Clock alignment is three-stage:

  1. anchors — each dump's events map to wall time via its own anchor
     (re-sampled at dump time); honest clocks land within NTP error.
  2. causal refinement (`estimate_offsets`) — per-height landmark events
     (commit, falling back to parts-complete then proposal for nodes
     that joined late via fastsync and hold no commit for the shared
     window) are near-simultaneous across nodes; each node's median
     residual against the per-height cross-node median estimates its
     clock offset, robustly (a minority of skewed clocks cannot drag the
     median).  The estimate deliberately folds a node's *systematic*
     commit lag into its "offset" — separating the two needs
     message-level one-way-delay estimation, which is exactly what stage
     3 adds; the residual skew this leaves is bounded by real commit
     skew, orders of magnitude below a seconds-scale clock fault.
     Offsets are reported per node so a skewed
     clock is VISIBLE, not silently fixed.
  3. measured skew (`measured_offsets`) — when peers speak the wire
     trace tier (gossip_version >= 3), every received frame carries the
     sender's send-wall stamp and the receiver's `gossip.hop` events
     record origin-vs-receive latency directly.  Per node, the median of
     direct (hop 0, unclamped, non-block_part — their cached frames
     carry stale stamps) latencies is one-way-delay + that node's clock
     offset; normalizing across the fleet's medians cancels the common
     delay term.  `merge` prefers measured offsets over landmark
     estimates whenever a node has enough samples, and reports per-node
     sample counts and the source of each offset so the operator can see
     WHICH alignment each node got.

Dumps may arrive out of order, overlap in wall time or cover different
height windows — everything is keyed by height and node name, and events
are (re)sorted on ingest.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from . import loopprof, tracing


def load_dump(path: str, name: str = "") -> dict:
    """Read one recorder dump from disk: a raw snapshot (what
    FlightRecorder.snapshot / `trace --json` emit), a JSON-RPC response
    wrapping one under "result", or a crash spool (the JSON-lines journal
    `[instrumentation] flight_spool` writes) — so a DEAD node's on-disk
    spool merges into the network timeline exactly like a live node's RPC
    dump.  `name` overrides the node label (default: the dump's own
    `node` field, else the file stem)."""
    try:
        with open(path) as fh:
            d = json.load(fh)
    except ValueError:
        # not one JSON document — a JSON-lines spool (torn-tail tolerant)
        d = tracing.read_spool(path, name=name)
        if not d["events"]:
            raise ValueError(f"{path}: neither a flight-recorder dump nor a spool")
    else:
        if isinstance(d, dict) and d.get("type") == "anchor":
            # a one-line spool (anchor written, no events yet) parses as
            # plain JSON — still a spool
            d = tracing.read_spool(path, name=name)
    if "result" in d and isinstance(d["result"], dict) and "events" in d["result"]:
        d = d["result"]
    if "events" not in d:
        raise ValueError(f"{path}: not a flight-recorder dump")
    if name:
        d["node"] = name
    elif not d.get("node"):
        import os

        d["node"] = os.path.splitext(os.path.basename(path))[0]
    d["events"] = sorted(d["events"], key=lambda ev: ev.get("seq", 0))
    return d


def _normalize(dump: dict) -> dict:
    """Time-order a dump's events in place (idempotent).  load_dump sorts
    on ingest, but dumps also arrive programmatically (rig snapshots,
    tests) and every `_first_events` consumer needs time order."""
    dump["events"] = sorted(
        dump["events"], key=lambda ev: (ev.get("t_ns", 0), ev.get("seq", 0))
    )
    return dump


def _anchor_wall(dump: dict, t_ns: int) -> Optional[int]:
    """Map a recorder-local monotonic timestamp to wall ns via the dump's
    anchor; None when the dump predates the anchor feature."""
    a = dump.get("anchor")
    if not a:
        return None
    return a["wall_ns"] + (t_ns - a["mono_ns"])


def _first_events(dump: dict, kind: str, height_field: str = "height") -> Dict[int, dict]:
    """First event of `kind` per height in one dump."""
    out: Dict[int, dict] = {}
    for ev in dump["events"]:
        if ev.get("kind") == kind and height_field in ev:
            out.setdefault(ev[height_field], ev)
    return out


def _median(xs: Sequence[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _pctl(xs: Sequence[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(q * len(xs)))]


#: Landmark kinds estimate_offsets anchors on, tried in order.  Commit is
#: the tightest (near-simultaneous by construction); a node that joined
#: late (fastsync) may hold NO commit event for the shared window, and its
#: offset used to silently degrade to 0 — parts-complete and proposal
#: events are looser landmarks but still land within a propagation delay.
LANDMARK_KINDS = ("commit", "block.parts_complete", "proposal")

#: Minimum direct-frame latency samples before merge() trusts a node's
#: MEASURED offset over the landmark estimate.  A handful of samples is
#: one noisy burst; eight spans several heights of traffic.
MEASURED_MIN_SAMPLES = 8


def estimate_offsets(dumps: List[dict], detail: bool = False):
    """Per-dump clock-offset estimate (ns, to SUBTRACT from that dump's
    anchor-aligned wall times), from per-height shared landmarks.  Each
    kind in LANDMARK_KINDS is tried in order and a node keeps the FIRST
    kind that yields any residuals, so a fastsync joiner without commits
    falls back instead of silently getting 0.  Zero for dumps lacking
    anchors or any shared landmark heights.

    detail=True returns (offsets, samples, kinds): per-node residual
    sample counts (0 = unaligned) and the landmark kind each node used
    ("" = none) — merge() surfaces both."""
    n = len(dumps)
    offsets = [0] * n
    samples = [0] * n
    kinds = [""] * n
    for kind in LANDMARK_KINDS:
        unresolved = [i for i in range(n) if samples[i] == 0]
        if not unresolved:
            break
        firsts = [_first_events(d, kind) for d in dumps]
        # per-height anchor-aligned landmark walls across nodes
        per_height: Dict[int, List[Optional[int]]] = {}
        for i, fm in enumerate(firsts):
            for h, ev in fm.items():
                w = _anchor_wall(dumps[i], ev["t_ns"])
                if w is None:
                    continue
                per_height.setdefault(h, [None] * n)[i] = w
        refs: Dict[int, float] = {
            h: _median([w for w in ws if w is not None])
            for h, ws in per_height.items()
            if sum(w is not None for w in ws) >= 2
        }
        for i in unresolved:
            residuals = [
                per_height[h][i] - refs[h]
                for h in refs
                if per_height[h][i] is not None
            ]
            if residuals:
                offsets[i] = int(_median(residuals))
                samples[i] = len(residuals)
                kinds[i] = kind
    if detail:
        return offsets, samples, kinds
    return offsets


def measured_offsets(dumps: List[dict]):
    """Per-dump MEASURED clock offsets (ns) from wire-level trace context
    (`gossip.hop` events, gossip_version >= 3).  A direct frame's latency
    sample is receiver_wall − sender_send_wall = one-way delay + the
    receiver's clock offset relative to the sender; the per-node median
    over many senders is delay + that node's offset relative to the fleet,
    and subtracting the fleet-wide median of medians cancels the common
    delay term.  Only trustworthy samples count: lat_ms present, not
    clamped (byzantine fields never reach here), hop == 0 (relayed frames
    fold relay queueing into "delay"), and frame != block_part (cached
    part frames carry stale send stamps — see reactor._part_frame).

    Returns (offsets, samples); all-zero offsets when fewer than 2 nodes
    have samples (nothing to normalize against)."""
    n = len(dumps)
    meds: List[Optional[float]] = [None] * n
    samples = [0] * n
    for i, d in enumerate(dumps):
        lats = [
            ev["lat_ms"]
            for ev in d["events"]
            if ev.get("kind") == "gossip.hop"
            and ev.get("lat_ms") is not None
            and not ev.get("clamped")
            and ev.get("hop") == 0
            and ev.get("frame") != "block_part"
        ]
        if lats:
            meds[i] = _median(lats)
            samples[i] = len(lats)
    valid = [m for m in meds if m is not None]
    if len(valid) < 2:
        return [0] * n, samples
    base = _median(valid)
    offsets = [
        int((m - base) * 1e6) if m is not None else 0 for m in meds
    ]
    return offsets, samples


def merge(dumps: List[dict], causal: bool = True) -> dict:
    """Merge N dumps into the network timeline.  Returns

      {"nodes", "offsets_ms", "t0_wall_ns", "heights": {h: {...}},
       "offset_samples", "offset_sources",
       "commit_skew_ms_p50", "commit_skew_ms_p90",
       "coverage_ms_p50", "coverage_ms_p90", "hash_mismatch_heights"}

    Per height: proposal_ms + origin (the src="self" proposal event),
    parts_complete_ms / prevote_maj23_ms / precommit_maj23_ms / commit_ms
    per node (wall ms relative to t0), coverage_p50/p90_ms (proposal →
    parts-complete deltas across nodes), commit_skew_ms, and block hash
    agreement.  All times use anchor alignment minus the causal offsets
    (causal=False keeps raw anchors)."""
    names = [d.get("node", f"node{i}") for i, d in enumerate(dumps)]
    for d in dumps:
        _normalize(d)
    n = len(dumps)
    offsets = [0] * n
    offset_samples = [0] * n
    offset_sources = ["anchor"] * n
    if causal:
        est, est_samples, est_kinds = estimate_offsets(dumps, detail=True)
        meas, meas_samples = measured_offsets(dumps)
        for i in range(n):
            if meas_samples[i] >= MEASURED_MIN_SAMPLES:
                offsets[i] = meas[i]
                offset_samples[i] = meas_samples[i]
                offset_sources[i] = "measured"
            elif est_samples[i] > 0:
                offsets[i] = est[i]
                offset_samples[i] = est_samples[i]
                offset_sources[i] = f"landmark:{est_kinds[i]}"

    def wall(i: int, t_ns: int) -> Optional[int]:
        w = _anchor_wall(dumps[i], t_ns)
        return None if w is None else w - offsets[i]

    proposals = [_first_events(d, "proposal") for d in dumps]
    parts = [_first_events(d, "block.parts_complete") for d in dumps]
    commits = [_first_events(d, "commit") for d in dumps]
    chains = [tracing.step_chains(d["events"]) for d in dumps]

    heights = sorted({h for cm in commits for h in cm})
    all_walls = [
        w
        for i, cm in enumerate(commits)
        for ev in cm.values()
        if (w := wall(i, ev["t_ns"])) is not None
    ]
    t0 = min(all_walls) if all_walls else 0

    def rel_ms(w: Optional[int]) -> Optional[float]:
        return None if w is None else round((w - t0) / 1e6, 3)

    out_heights: Dict[int, dict] = {}
    skews: List[float] = []
    coverages: List[float] = []
    mismatches: List[int] = []
    for h in heights:
        entry: dict = {"height": h}
        # proposal born: prefer the src="self" event (the proposer)
        prop_w, origin = None, None
        for i, pm in enumerate(proposals):
            ev = pm.get(h)
            if ev is None:
                continue
            w = wall(i, ev["t_ns"])
            if w is None:
                continue
            if ev.get("src") == "self":
                prop_w, origin = w, names[i]
                break
            if prop_w is None or w < prop_w:
                prop_w, origin = w, names[i]
        entry["proposal_ms"] = rel_ms(prop_w)
        entry["origin"] = origin

        per_node: Dict[str, dict] = {}
        commit_ws: List[int] = []
        cover: List[float] = []
        hashes = set()
        for i, name in enumerate(names):
            node_entry: dict = {}
            pev = parts[i].get(h)
            if pev is not None:
                w = wall(i, pev["t_ns"])
                node_entry["parts_complete_ms"] = rel_ms(w)
                if w is not None and prop_w is not None:
                    cover.append((w - prop_w) / 1e6)
            steps = chains[i].get(h, {})
            # entering Precommit = prevote maj23 (or prevote-wait lapse);
            # entering Commit = precommit maj23 — the per-node aggregation
            # landmarks of the vote rounds
            if "Precommit" in steps:
                node_entry["prevote_maj23_ms"] = rel_ms(wall(i, steps["Precommit"]))
            if "Commit" in steps:
                node_entry["precommit_maj23_ms"] = rel_ms(wall(i, steps["Commit"]))
            cev = commits[i].get(h)
            if cev is not None:
                w = wall(i, cev["t_ns"])
                node_entry["commit_ms"] = rel_ms(w)
                if w is not None:
                    commit_ws.append(w)
                if "block" in cev:
                    hashes.add(cev["block"])
            if node_entry:
                per_node[name] = node_entry
        entry["nodes"] = per_node
        if len(commit_ws) >= 2:
            skew = (max(commit_ws) - min(commit_ws)) / 1e6
            entry["commit_skew_ms"] = round(skew, 3)
            skews.append(skew)
        if cover:
            entry["coverage_p50_ms"] = round(_pctl(cover, 0.5), 3)
            entry["coverage_p90_ms"] = round(_pctl(cover, 0.9), 3)
            coverages.extend(cover)
        if len(hashes) > 1:
            mismatches.append(h)
            entry["hash_mismatch"] = sorted(hashes)
        out_heights[h] = entry

    return {
        "nodes": names,
        "offsets_ms": [round(o / 1e6, 3) for o in offsets],
        "offset_samples": offset_samples,
        "offset_sources": offset_sources,
        "t0_wall_ns": t0,
        "heights": out_heights,
        "commit_skew_ms_p50": round(_pctl(skews, 0.5), 3) if skews else None,
        "commit_skew_ms_p90": round(_pctl(skews, 0.9), 3) if skews else None,
        "coverage_ms_p50": round(_pctl(coverages, 0.5), 3) if coverages else None,
        "coverage_ms_p90": round(_pctl(coverages, 0.9), 3) if coverages else None,
        "hash_mismatch_heights": mismatches,
    }


def attribution_by_height(dump: dict) -> Dict[int, dict]:
    """Per-height loop attribution for ONE dump: each interval between
    consecutive commit events (recorder-local monotonic time — no cross-
    node alignment involved) decomposed by loopprof.attribution.  Keyed
    by the interval's ENDING height; empty when the dump carries no
    profiler events (loop_profiler off, or another in-proc node owns the
    process hooks)."""
    commits = _first_events(_normalize(dump), "commit")
    heights = sorted(commits)
    out: Dict[int, dict] = {}
    for prev, h in zip(heights, heights[1:]):
        if h != prev + 1:
            continue
        att = loopprof.attribution(
            dump["events"], commits[prev]["t_ns"], commits[h]["t_ns"]
        )
        if att is not None:
            out[h] = att
    return out


def median_attribution(by_height: Dict[int, dict]) -> Optional[dict]:
    """Median share per key across a node's per-height attributions —
    the one-line summary `trace-net` prints per node."""
    if not by_height:
        return None
    keys = sorted({k for att in by_height.values() for k in att})
    return {
        k: round(_median([att.get(k, 0.0) for att in by_height.values()]), 1)
        for k in keys
    }


def slowest_height(merged: dict) -> Optional[int]:
    """The height whose commit sat longest after its predecessor's —
    where the rig's wall time actually went."""
    hs = merged["heights"]
    best, best_dt = None, -1.0
    for h in sorted(hs):
        prev = hs.get(h - 1)
        if prev is None:
            continue
        cur_cs = [v.get("commit_ms") for v in hs[h]["nodes"].values()]
        prev_cs = [v.get("commit_ms") for v in prev["nodes"].values()]
        cur_cs = [c for c in cur_cs if c is not None]
        prev_cs = [c for c in prev_cs if c is not None]
        if not cur_cs or not prev_cs:
            continue
        dt = _median(cur_cs) - _median(prev_cs)
        if dt > best_dt:
            best, best_dt = h, dt
    return best


def check(dumps: List[dict], merged: dict, require_attribution: bool = True) -> List[str]:
    """The `trace-net --check` gate.  Returns a list of failures (empty =
    pass): every node's interior recorded heights must have complete (or
    honestly `truncated`) span chains with no mid-chain holes, the merged
    timeline must cover every interior height with a proposal + commits,
    and — when required — at least one node must produce a nonzero
    attribution for every interior block interval."""
    failures: List[str] = []
    for d in dumps:
        # a watermarked dump (since > 0) legitimately starts mid-chain,
        # same as a wrapped ring — the snapshot self-describes both
        rep = tracing.span_report(
            d["events"], dropped=d.get("dropped", 0), since=d.get("since", 0)
        )
        if rep["bad"]:
            failures.append(f"{d.get('node')}: broken span chains {rep['bad']}")
        if not rep["complete"] and rep["interior"]:
            failures.append(f"{d.get('node')}: no complete span chain survived")
    heights = sorted(merged["heights"])
    interior = heights[1:-1]
    if not interior:
        failures.append(f"merged timeline too thin: {len(heights)} heights")
    for h in interior:
        entry = merged["heights"][h]
        if entry.get("proposal_ms") is None:
            failures.append(f"height {h}: no proposal event on any node")
        if not any("commit_ms" in v for v in entry["nodes"].values()):
            failures.append(f"height {h}: no aligned commit on any node")
    if merged["hash_mismatch_heights"]:
        failures.append(f"block hash mismatch at {merged['hash_mismatch_heights']}")
    if require_attribution and interior:
        atts = [attribution_by_height(d) for d in dumps]
        for h in interior:
            per_node = [a.get(h) for a in atts]
            good = [
                a for a in per_node
                if a is not None and any(v > 0 for k, v in a.items() if k.endswith("_pct"))
            ]
            if not good:
                failures.append(f"height {h}: zero loop attribution on every node")
    return failures


def format_timeline(merged: dict, heights: Optional[Sequence[int]] = None) -> str:
    """Human-readable per-height network timeline (the trace-net default
    output)."""
    sources = merged.get("offset_sources") or [""] * len(merged["nodes"])
    samples = merged.get("offset_samples") or [0] * len(merged["nodes"])
    lines = [
        "nodes: " + ", ".join(
            f"{n} (offset {o:+.1f} ms"
            + (f", {src} n={cnt}" if src else "")
            + ")"
            for n, o, src, cnt in zip(
                merged["nodes"], merged["offsets_ms"], sources, samples
            )
        ),
    ]
    if merged.get("commit_skew_ms_p50") is not None:
        lines.append(
            f"commit skew p50/p90: {merged['commit_skew_ms_p50']}/"
            f"{merged['commit_skew_ms_p90']} ms; part coverage p50/p90: "
            f"{merged.get('coverage_ms_p50')}/{merged.get('coverage_ms_p90')} ms"
        )
    for h in heights if heights is not None else sorted(merged["heights"]):
        e = merged["heights"].get(h)
        if e is None:
            continue
        lines.append(
            f"height {h}: proposal +{e.get('proposal_ms')}ms from "
            f"{e.get('origin')}"
            + (f"  coverage p90 {e['coverage_p90_ms']}ms"
               if "coverage_p90_ms" in e else "")
            + (f"  commit skew {e['commit_skew_ms']}ms"
               if "commit_skew_ms" in e else "")
        )
        for name in merged["nodes"]:
            v = e["nodes"].get(name)
            if not v:
                continue
            lines.append(
                f"    {name:<12}"
                + "".join(
                    f" {label} +{v[key]}ms"
                    for label, key in (
                        ("parts", "parts_complete_ms"),
                        ("prevote-maj23", "prevote_maj23_ms"),
                        ("precommit-maj23", "precommit_maj23_ms"),
                        ("commit", "commit_ms"),
                    )
                    if v.get(key) is not None
                )
            )
    return "\n".join(lines)


def format_attribution(dumps: List[dict]) -> str:
    """Per-node attribution table (median shares across block intervals)."""
    lines = ["per-node block attribution (median % of block wall time):"]
    for d in dumps:
        med = median_attribution(attribution_by_height(d))
        if med is None:
            lines.append(f"  {d.get('node'):<12} (no profiler events)")
            continue
        shares = " ".join(
            f"{k[:-4]}={v}%" for k, v in sorted(med.items())
            if k.endswith("_pct") and v > 0
        )
        lines.append(f"  {d.get('node'):<12} {shares}")
    return "\n".join(lines)
