"""The port's cross-node trace merge (tendermint_tpu_torch/libs/tracemerge.py)
against the JAX package's, tolerance exact: for the same dumps every
function returns an equal value (dicts, lists, ints, floats from the same
arithmetic) and every formatter an equal string.

Dumps come from synthetic dumps (the JAX tests' shapes: skewed anchors,
shuffled and overlapping windows, hash mismatches, profiler events, wire
trace hops), from a seeded numpy generator, from an in-process
4-validator port net's recorders (`device="cpu"`, memdb, timeout_commit
0.05 s) and from crash spools written by either package: the port merges
a JAX spool and the JAX package merges the port's.
"""

import asyncio
import copy
import json
import os
import random
import time

import numpy as np
import pytest

from tendermint_tpu.libs import tracemerge as jmerge
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.libs import tracemerge as pmerge
from tendermint_tpu_torch.libs import tracing as ptracing

MODS = {"port": pmerge, "jax": jmerge}


def both(fn, *args, **kwargs):
    """fn(module, *args) in each package on deep copies of the arguments;
    asserts the two results are equal and returns the port's."""
    got = {name: fn(mod, *copy.deepcopy(args), **copy.deepcopy(kwargs))
           for name, mod in MODS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def synthetic_dump(node, heights, anchor_wall_ns=10_000_000_000, commit_ns=1_000_000_000,
                   shuffle=None):
    """The JAX tests' dump: commits at t_ns = h * commit_ns on a monotonic
    scale anchored at mono_ns = 0."""
    events = []
    seq = 0
    for h in heights:
        for step in ("Propose", "Prevote", "Precommit", "Commit"):
            events.append({"seq": seq, "t_ns": h * commit_ns - 1000 + seq,
                           "kind": "step", "height": h, "round": 0, "step": step})
            seq += 1
        events.append({"seq": seq, "t_ns": h * commit_ns, "kind": "commit",
                       "height": h, "txs": 0, "block": f"hash{h}"})
        seq += 1
        events.append({"seq": seq, "t_ns": h * commit_ns + 500, "kind": "proposal",
                       "height": h + 1, "round": 0,
                       "src": "self" if h % 2 else "ab12cd34"})
        seq += 1
    if shuffle is not None:
        random.Random(shuffle).shuffle(events)
    return {"enabled": True, "size": 8192, "next_seq": seq, "dropped": 0,
            "anchor": {"mono_ns": 0, "wall_ns": anchor_wall_ns}, "events": events,
            "node": node}


def with_profiler(d):
    """One loop.busy and one loop.lag inside every commit interval."""
    for h in (1, 2, 3):
        mid = h * 1_000_000_000 + 500_000_000
        d["events"].append({"seq": 900 + h * 2, "t_ns": mid, "kind": "loop.busy",
                            "interval_ms": 250.0, "consensus_ms": 400.0, "gossip_ms": 100.0})
        d["events"].append({"seq": 901 + h * 2, "t_ns": mid + 1000, "kind": "loop.lag",
                            "lag_ms": 50.0})
    return d


def hop(lat_ms, hop_=0, frame="vote_batch", t_ns=0, clamped=False):
    ev = {"kind": "gossip.hop", "frame": frame, "hop": hop_, "lat_ms": lat_ms, "t_ns": t_ns}
    if clamped:
        ev["clamped"] = 1
        del ev["lat_ms"]
    return ev


def bare(name, wall_offset_ns=0, events=()):
    return {"node": name, "anchor": {"mono_ns": 0, "wall_ns": 10**12 + wall_offset_ns},
            "events": list(events)}


def seeded_dumps(seed, nodes=3, heights=8):
    """Dumps of `nodes` nodes over the same heights from a seeded numpy
    generator: per-node clock offsets and commit lags, proposals (one
    origin), parts, maj23 steps, wire hops (some relayed, some clamped)
    and profiler events."""
    rng = np.random.default_rng(seed)
    out = []
    base = 5 * 10**9
    block_ms = rng.uniform(80, 400, heights)
    for i in range(nodes):
        events, seq = [], 0
        skew = int(rng.integers(-2 * 10**9, 2 * 10**9))
        lag = rng.uniform(0, 30, heights)
        for h in range(1, heights + 1):
            t0 = base + int(block_ms[:h].sum() * 1e6 + lag[h - 1] * 1e6)
            evs = [("proposal", {"height": h, "round": 0,
                                 "src": "self" if h % nodes == i else f"{h:08x}"}, 0),
                   ("block.parts_complete", {"height": h, "round": 0, "parts": 1}, 2),
                   ("step", {"height": h, "round": 0, "step": "Propose"}, 1),
                   ("step", {"height": h, "round": 0, "step": "Prevote"}, 3),
                   ("step", {"height": h, "round": 0, "step": "Precommit"}, 9),
                   ("step", {"height": h, "round": 0, "step": "Commit"}, 15),
                   ("commit", {"height": h, "txs": int(rng.integers(0, 9)),
                               "block": f"{h * 7919:08x}"}, 15),
                   ("loop.busy", {"interval_ms": 250.0,
                                  "consensus_ms": round(float(rng.uniform(0, 200)), 3),
                                  "gossip_ms": round(float(rng.uniform(0, 50)), 3)}, 20),
                   ("loop.lag", {"lag_ms": round(float(rng.uniform(0, 5)), 3)}, 21)]
            for k in range(int(rng.integers(1, 4))):
                f = {"frame": str(rng.choice(["vote_batch", "proposal", "block_part", "vote"])),
                     "hop": int(rng.integers(0, 3)), "h": h, "peer": f"{k:08x}"}
                if rng.random() < 0.1:
                    f["clamped"] = 1
                else:
                    f["lat_ms"] = round(float(rng.uniform(0.1, 40)), 3) + 1000 * i
                evs.append(("gossip.hop", f, 4 + k))
            for kind, fields, dt in evs:
                events.append({"seq": seq, "t_ns": t0 + int(dt * 1e6), "kind": kind, **fields})
                seq += 1
        rng.shuffle(events)
        out.append({"enabled": True, "size": 8192, "next_seq": seq, "dropped": 0,
                    "anchor": {"mono_ns": 0, "wall_ns": 10**12 + skew},
                    "events": events, "node": f"n{i}"})
    return out


# -- load_dump ------------------------------------------------------------


def test_load_dump_raw_rpc_wrapped_and_naming(tmp_path):
    raw = synthetic_dump("", [1, 2])
    del raw["node"]
    p1 = tmp_path / "n0.json"
    p1.write_text(json.dumps(raw))
    d = both(lambda m, p: m.load_dump(p), str(p1))
    assert d["node"] == "n0"
    p2 = tmp_path / "wrapped.json"
    p2.write_text(json.dumps({"jsonrpc": "2.0", "id": 1,
                              "result": synthetic_dump("rpc-node", [1])}))
    assert both(lambda m, p: m.load_dump(p), str(p2))["node"] == "rpc-node"
    assert both(lambda m, p: m.load_dump(p, name="override"), str(p2))["node"] == "override"


def test_load_dump_rejects_a_non_dump_as_jax_does(tmp_path):
    p = tmp_path / "junk.json"
    p.write_text(json.dumps({"hello": 1}))
    texts = []
    for mod in MODS.values():
        with pytest.raises(ValueError, match="not a flight-recorder dump") as e:
            mod.load_dump(str(p))
        texts.append(str(e.value))
    assert texts[0] == texts[1]


# -- clock alignment --------------------------------------------------------


def test_estimate_offsets_recovers_anchor_skew():
    dumps = [synthetic_dump("n0", range(1, 8)), synthetic_dump("n1", range(1, 8)),
             synthetic_dump("n2", range(1, 8), anchor_wall_ns=15_000_000_000)]
    offsets = both(lambda m, d: m.estimate_offsets(d), dumps)
    assert abs(offsets[0]) < 1_000_000 and abs(offsets[1]) < 1_000_000
    assert abs(offsets[2] - 5_000_000_000) < 1_000_000
    assert both(lambda m, d: m.estimate_offsets(d, detail=True), dumps)[2] == ["commit"] * 3


@pytest.mark.parametrize("causal", [True, False])
def test_merge_corrects_skew_and_reports_it(causal):
    dumps = [synthetic_dump("n0", range(1, 8)), synthetic_dump("n1", range(1, 8)),
             synthetic_dump("n2", range(1, 8), anchor_wall_ns=15_000_000_000)]
    merged = both(lambda m, d: m.merge(d, causal=causal), dumps)
    if causal:
        assert merged["offsets_ms"][2] == pytest.approx(5000.0, abs=1.0)
        assert merged["commit_skew_ms_p90"] == pytest.approx(0.0, abs=1.0)
    else:
        assert merged["commit_skew_ms_p90"] == pytest.approx(5000.0, abs=1.0)


def test_skewed_wall_clock_recorders_align():
    """Real recorders of both packages, one of each pair dumping through a
    wall clock 2 s ahead: equal events give equal offsets and merges."""
    skew_ns = 2_000_000_000
    recs = [ptracing.FlightRecorder(size=256), ptracing.FlightRecorder(size=256),
            ptracing.FlightRecorder(size=256, wall_ns_fn=lambda: time.time_ns() + skew_ns)]
    for h in range(1, 7):
        for r in recs:
            r.record("commit", height=h, txs=0, block=f"h{h}")
        time.sleep(0.002)
    dumps = []
    for i, r in enumerate(recs):
        snap = r.snapshot()
        snap["node"] = f"n{i}"
        dumps.append(snap)
    offsets = both(lambda m, d: m.estimate_offsets(d), dumps)
    assert offsets[2] / 1e9 == pytest.approx(skew_ns / 1e9, abs=0.1)
    merged = both(lambda m, d: m.merge(d), dumps)
    assert merged["commit_skew_ms_p90"] < 100.0


def test_anchorless_dumps_do_not_crash():
    d0, d1 = synthetic_dump("old0", [1, 2, 3]), synthetic_dump("old1", [1, 2, 3])
    del d0["anchor"], d1["anchor"]
    merged = both(lambda m, a, b: m.merge([a, b]), d0, d1)
    assert merged["offsets_ms"] == [0.0, 0.0] and merged["commit_skew_ms_p90"] is None


def test_shuffled_events_and_different_height_windows():
    d0 = synthetic_dump("n0", range(1, 7), shuffle=13)
    d1 = synthetic_dump("n1", range(3, 10), shuffle=37, anchor_wall_ns=15_000_000_000)
    merged = both(lambda m, a, b: m.merge([a, b]), d0, d1)
    assert sorted(merged["heights"]) == list(range(1, 10))
    assert merged["offsets_ms"][1] - merged["offsets_ms"][0] == pytest.approx(5000.0, abs=1.0)


def test_hash_mismatch_detected():
    d0, d1 = synthetic_dump("n0", [1, 2, 3]), synthetic_dump("n1", [1, 2, 3])
    for ev in d1["events"]:
        if ev["kind"] == "commit" and ev["height"] == 2:
            ev["block"] = "DIFFERENT"
    merged = both(lambda m, a, b: m.merge([a, b]), d0, d1)
    assert merged["hash_mismatch_heights"] == [2]
    failures = both(lambda m, a, b, mg: m.check([a, b], mg, require_attribution=False),
                    d0, d1, merged)
    assert any("hash mismatch" in f for f in failures)


def test_measured_offsets_and_their_filters():
    a = bare("a", events=[hop(10.0, t_ns=i) for i in range(9)])
    b = bare("b", events=[hop(30.0, t_ns=i) for i in range(9)])
    assert both(lambda m, d: m.measured_offsets(d), [a, b]) == (
        [-10_000_000, 10_000_000], [9, 9])
    tainted = [hop(500.0, hop_=2), hop(500.0, frame="block_part"), hop(500.0, clamped=True),
               {"kind": "gossip.hop", "frame": "vote", "hop": 0, "t_ns": 0}]
    a = bare("a", events=[hop(10.0, t_ns=i) for i in range(9)] + tainted)
    b = bare("b", events=[hop(10.0, t_ns=i) for i in range(9)])
    assert both(lambda m, d: m.measured_offsets(d), [a, b]) == ([0, 0], [9, 9])
    assert both(lambda m, d: m.measured_offsets(d), [a, bare("c")]) == ([0, 0], [9, 0])


def test_landmark_fallback_and_offset_sources():
    ms = 1_000_000
    shared = [(h, h * 100 * ms) for h in (3, 4, 5)]

    def commit(h, t):
        return {"kind": "commit", "height": h, "block": "cd" * 4, "t_ns": t}

    def proposal(h, t):
        return {"kind": "proposal", "height": h, "t_ns": t}

    a = bare("a", events=[commit(h, t) for h, t in shared]
             + [proposal(h, t - 10 * ms) for h, t in shared])
    b = copy.deepcopy(a)
    b["node"] = "b"
    c = bare("c", wall_offset_ns=50 * ms, events=[proposal(h, t - 10 * ms) for h, t in shared])
    offsets, samples, kinds = both(lambda m, d: m.estimate_offsets(d, detail=True), [a, b, c])
    assert kinds == ["commit", "commit", "proposal"] and samples[2] == 3
    assert offsets[2] == pytest.approx(50 * ms, abs=2 * ms)
    commits = [commit(h, t) for h, t in shared]
    a = bare("a", events=commits + [hop(10.0, t_ns=i) for i in range(8)])
    b = bare("b", events=commits + [hop(30.0, t_ns=i) for i in range(8)])
    c = bare("c", events=list(commits) + [hop(20.0, t_ns=0)])
    merged = both(lambda m, d: m.merge(d), [a, b, c])
    assert merged["offset_sources"] == ["measured", "measured", "landmark:commit"]
    both(lambda m, mg: m.format_timeline(mg), merged)


# -- attribution and the gate -----------------------------------------------


def test_attribution_by_height_and_median():
    d = with_profiler(synthetic_dump("n0", [1, 2, 3, 4]))
    by_h = both(lambda m, x: m.attribution_by_height(x), d)
    assert sorted(by_h) == [2, 3, 4]
    for att in by_h.values():
        assert att["consensus_pct"] == pytest.approx(40.0)
    assert both(lambda m, x: m.median_attribution(x), by_h)["consensus_pct"] == pytest.approx(40.0)
    assert both(lambda m: m.median_attribution({})) is None
    gap = synthetic_dump("n0", [1, 2, 5, 6])
    assert both(lambda m, x: m.attribution_by_height(x), gap) == {}


def test_check_requires_attribution_on_some_node():
    plain = synthetic_dump("n0", [1, 2, 3, 4])
    merged = both(lambda m, d: m.merge([d]), plain)
    failures = both(lambda m, d, mg: m.check([d], mg), plain, merged)
    assert any("zero loop attribution" in f for f in failures)
    prof = with_profiler(synthetic_dump("n0", [1, 2, 3, 4]))
    merged = both(lambda m, d: m.merge([d]), prof)
    assert both(lambda m, d, mg: m.check([d], mg), prof, merged) == []


def test_slowest_height_and_formats():
    d = synthetic_dump("n0", [1, 2, 3])
    for ev in d["events"]:
        if ev.get("height") == 3 or (ev["kind"] == "proposal" and ev["height"] == 4):
            ev["t_ns"] += 2_000_000_000
    merged = both(lambda m, x: m.merge([x]), d)
    assert both(lambda m, mg: m.slowest_height(mg), merged) == 3
    prof = with_profiler(synthetic_dump("n0", [1, 2, 3, 4]))
    merged = both(lambda m, x: m.merge([x]), prof)
    text = both(lambda m, mg: m.format_timeline(mg), merged)
    assert "height 2" in text and "commit" in text
    assert "consensus=" in both(lambda m, x: m.format_attribution([x]), prof)
    assert "(no profiler events)" in both(
        lambda m, x: m.format_attribution([x]), synthetic_dump("bare", [1, 2, 3]))
    assert both(lambda m, mg: m.format_timeline(mg, [2]), merged).count("height ") == 1


@pytest.mark.parametrize("seed", range(4))
def test_seeded_dumps_equal_jax(seed):
    dumps = seeded_dumps(seed)
    merged = both(lambda m, d: m.merge(d), dumps)
    assert merged["heights"] and merged["offset_sources"]
    both(lambda m, d: m.merge(d, causal=False), dumps)
    both(lambda m, d: m.estimate_offsets(d, detail=True), dumps)
    both(lambda m, d: m.measured_offsets(d), dumps)
    both(lambda m, d, mg: m.check(d, mg), dumps, merged)
    both(lambda m, d, mg: m.check(d, mg, require_attribution=False), dumps, merged)
    both(lambda m, mg: m.slowest_height(mg), merged)
    both(lambda m, mg: m.format_timeline(mg), merged)
    both(lambda m, d: m.format_attribution(d), dumps)
    for d in dumps:
        both(lambda m, x: m.median_attribution(m.attribution_by_height(x)), d)


# -- a port net's recorders ---------------------------------------------------


def port_net_nodes(tmp_path, n=4, name="tm", rpc=False, spool=False):
    """An in-process n-validator port net (the JAX four-node test's
    settings: memdb, timeout_commit 0.05 s, a 10 ms profiler probe), not
    started.  `rpc` serves RPC on a free port, `spool` turns the flight
    spool on."""
    import test_torch_net as tnet

    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.priv_validator import MockPV

    seeds = tnet._seeds(n, name)
    _, pg = tnet._genesis(seeds)
    nodes = []
    for i, seed in enumerate(seeds):
        cfg = test_config(str(tmp_path / f"{name}{i}"))
        cfg.base.moniker = f"{name}{i}"
        cfg.rpc.laddr = "tcp://127.0.0.1:0" if rpc else ""
        cfg.base.db_backend = "memdb"
        cfg.p2p.laddr = "127.0.0.1:0"
        cfg.p2p.pex = False
        cfg.consensus.skip_timeout_commit = False
        cfg.consensus.timeout_commit = 0.05
        cfg.instrumentation.loop_probe_interval = 0.01
        cfg.instrumentation.flight_spool = spool
        nodes.append(Node(cfg, pg, priv_validator=MockPV(Ed25519PrivKey(seed)),
                          db_backend="memdb", device="cpu"))
    return nodes


async def run_port_net(nodes, mark_at=3, top=9, inside=None, until=None):
    """Start and mesh `nodes`, take each recorder's watermark once all hold
    `mark_at` blocks, run to `top`, await `inside(nodes)` if given, and
    return each node's snapshot since its watermark (named by moniker);
    every node is stopped on return.  With `until(dumps)`, the net runs on
    past `top` (60 s at most) until the snapshots satisfy it: on a loaded
    host a node that lags skips steps (ROADMAP 3.10), and the heights to
    `top` may hold too few complete chains."""
    import test_torch_net as tnet

    def snapshots(marks):
        dumps = []
        for i, n in enumerate(nodes):
            snap = n.flight_recorder.snapshot(since=marks[i])
            snap["node"] = n.config.base.moniker
            dumps.append(snap)
        return dumps

    try:
        for n in nodes:
            await n.start()
        await tnet._mesh(nodes)
        await tnet._wait_height(nodes, mark_at, 60.0)
        marks = [n.flight_recorder.snapshot()["next_seq"] for n in nodes]
        await tnet._wait_height(nodes, top, 60.0)
        if inside is not None:
            await inside(nodes)
        dumps = snapshots(marks)
        deadline = time.monotonic() + 60.0
        while until is not None and not until(dumps) and time.monotonic() < deadline:
            await asyncio.sleep(0.25)
            dumps = snapshots(marks)
        return dumps
    finally:
        await tnet._stop(nodes)


@pytest.fixture(scope="module")
def net_dumps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracemerge-net")
    return asyncio.run(run_port_net(port_net_nodes(tmp)))


def test_four_port_nodes_merge_into_a_complete_timeline(net_dumps):
    """The JAX four-node gate on port nodes: the merged timeline covers the
    interior heights with a proposal, an origin and agreeing commits, and
    the full check (attribution included) passes, in both packages."""
    merged = both(lambda m, d: m.merge(d), net_dumps)
    assert len(merged["heights"]) >= 4
    assert all(abs(o) < 1000 for o in merged["offsets_ms"])
    interior = sorted(merged["heights"])[1:-1]
    assert interior
    for h in interior:
        entry = merged["heights"][h]
        assert entry["proposal_ms"] is not None and "hash_mismatch" not in entry
        assert entry["origin"] in {f"tm{i}" for i in range(4)}
        for name in (f"tm{i}" for i in range(4)):
            assert entry["nodes"][name].get("commit_ms") is not None
    assert both(lambda m, d, mg: m.check(d, mg), net_dumps, merged) == []
    by_height = both(lambda m, d: m.attribution_by_height(d), net_dumps[0])
    assert by_height and both(lambda m, b: m.median_attribution(b), by_height)


@pytest.mark.parametrize("what", ["estimate_offsets", "measured_offsets", "formats", "causal_off"])
def test_port_net_dumps_equal_jax(net_dumps, what):
    if what == "estimate_offsets":
        both(lambda m, d: m.estimate_offsets(d, detail=True), net_dumps)
    elif what == "measured_offsets":
        both(lambda m, d: m.measured_offsets(d), net_dumps)
    elif what == "formats":
        merged = both(lambda m, d: m.merge(d), net_dumps)
        both(lambda m, mg: m.format_timeline(mg), merged)
        both(lambda m, d: m.format_attribution(d), net_dumps)
        both(lambda m, mg: m.slowest_height(mg), merged)
    else:
        merged = both(lambda m, d: m.merge(d, causal=False), net_dumps)
        both(lambda m, d, mg: m.check(d, mg, require_attribution=False), net_dumps, merged)


# -- spools -------------------------------------------------------------------


def write_spool(pkg, path, node, heights):
    """A spool of `pkg` flushed once per height and never closed (the node
    was SIGKILLed); returns its recorder."""
    mod = ptracing if pkg == "port" else jtracing
    rec = mod.FlightRecorder(size=8192)
    sp = mod.FlightSpool(str(path), rec, node=node)
    for h in heights:
        rec.record("proposal", height=h, round=0, src="self")
        for step in ("Propose", "Prevote", "Precommit", "Commit"):
            rec.record("step", height=h, round=0, step=step)
        rec.record("commit", height=h, txs=0, block=f"hash{h}")
        sp.flush()
    return rec


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_merges_the_others_spool(writer, tmp_path):
    spool_path = tmp_path / "flight.spool"
    rec = write_spool(writer, spool_path, "dead-node", [1, 2, 3, 4])
    d = both(lambda m, p: m.load_dump(p), str(spool_path))
    assert d["node"] == "dead-node" and d["source"] == "spool"
    assert len(d["events"]) == len(rec.events())
    live = ptracing.FlightRecorder(size=8192)
    for h in [1, 2, 3, 4, 5]:
        live.record("proposal", height=h, round=0, src="self")
        for step in ("Propose", "Prevote", "Precommit", "Commit"):
            live.record("step", height=h, round=0, step=step)
        live.record("commit", height=h, txs=0, block=f"hash{h}")
    snap = live.snapshot()
    snap["node"] = "live-node"
    merged = both(lambda m, a, b: m.merge([a, b]), d, snap)
    shared = [h for h, e in merged["heights"].items()
              if {"dead-node", "live-node"} <= set(e["nodes"])]
    assert len(shared) == 4 and merged["hash_mismatch_heights"] == []
    assert both(lambda m, a, b, mg: m.check([a, b], mg, require_attribution=False),
                d, snap, merged) == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_spool_loads_and_junk_is_refused(writer, tmp_path):
    spool_path = tmp_path / "flight.spool"
    write_spool(writer, spool_path, "torn-node", [1, 2, 3])
    size = os.path.getsize(spool_path)
    with open(spool_path, "r+b") as f:
        f.truncate(size - 9)
    d = both(lambda m, p: m.load_dump(p), str(spool_path))
    assert d["torn"] == 1 and len(d["events"]) >= 3 * 6 - 1
    assert both(lambda m, p: m.load_dump(p, name="renamed"), str(spool_path))["node"] == "renamed"
    junk = tmp_path / "junk.txt"
    junk.write_text("not json\nat all\n")
    for mod in MODS.values():
        with pytest.raises(ValueError):
            mod.load_dump(str(junk))


def test_landmark_offsets_fold_a_followers_commit_lag_in_both_packages():
    """ROADMAP 3.11, pinned as the JAX package gives it: two nodes on one
    clock (anchor wall_ns = mono_ns = 0), B committing every height 2 s
    after A, no gossip hops.  With too few measured samples, merge takes
    each node's clock offset from the commit landmarks, which assume
    near-simultaneous commits, so B's 2 s lag becomes ±1 s of offset and
    the commit skew reads 0 where it is 2,000 ms."""
    sec = 1_000_000_000

    def dump(name, lag_ns):
        return {"node": name, "anchor": {"mono_ns": 0, "wall_ns": 0},
                "events": [{"seq": h, "t_ns": 10 * h * sec + lag_ns, "kind": "commit",
                            "height": h, "block": f"hash{h}"} for h in range(1, 7)]}

    merged = both(lambda m, d: m.merge(d), [dump("a", 0), dump("b", 2 * sec)])
    assert merged["offset_sources"] == ["landmark:commit", "landmark:commit"]
    assert merged["offsets_ms"] == [-1000.0, 1000.0]
    assert merged["commit_skew_ms_p50"] == 0
