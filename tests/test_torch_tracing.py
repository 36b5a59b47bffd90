"""The port's flight-recorder reports and crash spool
(tendermint_tpu_torch/libs/tracing.py) against the JAX package's,
tolerance exact: for the same events `step_chains`, `complete_heights`,
`span_report`, `block_breakdown`, `stage_budget`, `net_budget` return
equal dicts and `format_budget`, `format_net_budget` equal strings (the
same float arithmetic in the same order); a spool written by either
package replays to equal dicts in both.

Events come from a seeded numpy generator (chains with random step
timings, skipped steps, deliveries, proposals, parts, wire hops some of
them clamped) and from an in-process 4-validator port net's recorders
(`device="cpu"`).  The spool cases mirror the JAX package's: torn tail,
run segregation, the size cap, ring-wrap accounting, two spools' crash
hooks independent, and `record` unchanged with a spool attached.
ROADMAP 3.10 is pinned here: a chain whose node skipped PROPOSE or
PREVOTE (its proposal complete, or +2/3 precommits in, before the step)
is "bad" in both packages.
"""

import asyncio
import copy
import os
import sys
import time

import numpy as np
import pytest

from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.libs import tracing as ptracing

MODS = {"port": ptracing, "jax": jtracing}
STEPS = ("NewHeight", "NewRound", "Propose", "Prevote", "Precommit", "Commit")


def seeded_events(seed, heights=9):
    """One node's event stream from a seeded generator: per height its
    step chain (a step left out now and then), proposal, parts, wire hops,
    vote batches, commit and delivery span, and profiler ticks."""
    rng = np.random.default_rng(seed)
    events = []
    t = int(rng.integers(10**9, 2 * 10**9))

    def add(kind, dt_ms, **fields):
        nonlocal t
        t += int(dt_ms * 1e6)
        events.append({"seq": len(events), "t_ns": t, "kind": kind, **fields})

    for h in range(1, heights + 1):
        for step in STEPS:
            if step in ("Propose", "Prevote", "Precommit") and rng.random() < 0.08:
                continue
            add("step", float(rng.uniform(0.1, 60)), height=h, round=0, step=step)
            if step == "Propose":
                add("proposal", float(rng.uniform(0, 3)), height=h, round=0, src="self")
                for j in range(int(rng.integers(1, 4))):
                    f = {"frame": str(rng.choice(["proposal", "block_part", "vote_batch"])),
                         "peer": f"{j:08x}", "origin": "ab" * 4, "hop": int(rng.integers(0, 3)),
                         "h": h}
                    if rng.random() < 0.1:
                        f["clamped"] = 1
                    else:
                        f["lat_ms"] = round(float(rng.uniform(0.05, 25)), 3)
                    add("gossip.hop", float(rng.uniform(0, 2)), **f)
                add("block.parts_complete", float(rng.uniform(0, 9)), height=h, round=0,
                    parts=1, src="self")
            if step == "Prevote":
                add("gossip.vote_batch_recv", float(rng.uniform(0, 4)), n=int(rng.integers(1, 99)),
                    dup=0, peer="cd" * 4, h=h)
        add("commit", float(rng.uniform(0, 2)), height=h, txs=int(rng.integers(0, 50)),
            block=f"{h:06x}")
        if rng.random() < 0.9:
            add("deliver.start", float(rng.uniform(0, 5)), height=h)
            add("deliver.end", float(rng.uniform(1, 30)), height=h)
        add("loop.lag", float(rng.uniform(0, 200)), lag_ms=round(float(rng.uniform(0, 9)), 3))
    return events


REPORTS = {
    "step_chains": lambda m, ev: m.step_chains(ev),
    "complete_heights": lambda m, ev: m.complete_heights(m.step_chains(ev)),
    "span_report": lambda m, ev: [m.span_report(ev), m.span_report(ev, dropped=7),
                                  m.span_report(ev, since=3)],
    "block_breakdown": lambda m, ev: m.block_breakdown(ev),
    "stage_budget": lambda m, ev: m.stage_budget(ev),
    "format_budget": lambda m, ev: m.format_budget(m.stage_budget(ev)),
    "net_budget": lambda m, ev: m.net_budget(ev),
    "format_net_budget": lambda m, ev: m.format_net_budget(m.net_budget(ev)),
    "statesync_bootstrap_ms": lambda m, ev: m.statesync_bootstrap_ms(ev),
}


def same(report, events):
    got = {name: REPORTS[report](mod, copy.deepcopy(events)) for name, mod in MODS.items()}
    assert got["port"] == got["jax"], report
    return got["port"]


@pytest.mark.parametrize("report", sorted(REPORTS))
def test_reports_equal_jax_on_seeded_events(report):
    results = [same(report, seeded_events(seed)) for seed in range(8)]
    if report == "stage_budget":
        assert any(r is not None and len(r["stages"]) == 6 for r in results)
    if report == "span_report":
        assert any(r[0]["bad"] for r in results) and any(r[0]["complete"] for r in results)
    assert same(report, []) == REPORTS[report](jtracing, [])


@pytest.fixture(scope="module")
def net_events(tmp_path_factory):
    """Each node's recorder events of an in-process 4-validator port net
    (tests/test_torch_tracemerge.py's settings), heights 3-9, or on until
    node 0's events hold a budget of every stage and a complete span."""
    import test_torch_tracemerge as tm

    def complete(dumps):
        events = dumps[0]["events"]
        budget = ptracing.stage_budget(events)
        return (budget is not None and set(budget["stages"]) == set(ptracing.BUDGET_STAGES)
                and bool(ptracing.span_report(events, since=1)["complete"]))

    nodes = tm.port_net_nodes(tmp_path_factory.mktemp("tracing-net"))
    return [d["events"] for d in asyncio.run(tm.run_port_net(nodes, until=complete))]


@pytest.mark.parametrize("report", sorted(REPORTS))
def test_reports_equal_jax_on_a_port_net(net_events, report):
    for events in net_events:
        same(report, events)
    budget = ptracing.stage_budget(net_events[0])
    assert budget is not None and set(budget["stages"]) == set(ptracing.BUDGET_STAGES)
    assert ptracing.span_report(net_events[0], since=1)["complete"]


@pytest.mark.parametrize("missing", ["Propose", "Prevote"])
def test_a_skipped_step_is_a_broken_chain_in_both_packages(missing):
    """ROADMAP 3.10: consensus legitimately skips PROPOSE when the
    proposal is complete before the step (reference state.go
    addProposalBlockPart -> enterPrevote) and PREVOTE when +2/3 precommits
    arrive first (addVote -> enterPrecommit, catch-up); span_report calls
    that height's chain bad, without a ring wrap or a watermark."""
    events = []
    for h in range(1, 6):
        for step in STEPS:
            if not (h == 3 and step == missing):
                events.append({"seq": len(events), "t_ns": len(events) * 1000, "kind": "step",
                               "height": h, "round": 0, "step": step})
    rep = same("span_report", events)
    assert rep[0]["bad"] == {3: [missing]} and rep[0]["complete"] == [2, 4]
    # with a wrap or a watermark a missing PROPOSE (a prefix) is "truncated"
    assert (rep[1]["truncated"], rep[2]["truncated"]) == (
        ([3], [3]) if missing == "Propose" else ([], []))


# -- the spool ------------------------------------------------------------------


def steps(rec, heights, round_=0):
    for h in heights:
        for s in ("Propose", "Prevote", "Precommit", "Commit"):
            rec.record("step", height=h, step=s, round=round_)
        rec.record("commit", height=h, txs=0, block="ab")


def read_both(path, name=""):
    """The spool replayed by each package: equal dicts, the port's returned."""
    got = {k: m.read_spool(path, name=name) for k, m in MODS.items()}
    assert got["port"] == got["jax"]
    assert ptracing.spool_paths(path) == jtracing.spool_paths(path)
    return got["port"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spool_roundtrip_replay_matches_ring_in_both_readers(writer, tmp_path):
    mod = MODS[writer]
    rec = mod.FlightRecorder(size=4096)
    sp = mod.FlightSpool(str(tmp_path / "flight.spool"), rec, node="n7")
    steps(rec, range(1, 8))
    sp.flush()
    sp.close()
    dump = read_both(str(tmp_path / "flight.spool"))
    assert dump["node"] == "n7" and dump["source"] == "spool"
    assert dump["dropped"] == 0 and dump["torn"] == 0 and dump["runs"] == 1
    assert [e["seq"] for e in dump["events"]] == [e["seq"] for e in rec.events()]
    assert dump["anchor"]["wall_ns"] > 0
    rep = ptracing.span_report(dump["events"], dropped=dump["dropped"])
    assert rep["bad"] == {} and len(rep["complete"]) == rep["interior"] == 5


def test_port_spool_lines_are_the_jax_lines(tmp_path):
    """Same run id, same recorder events: the two packages' spools hold the
    same lines but for the anchors' clock readings."""
    import json

    lines = {}
    for name, mod in MODS.items():
        rec = mod.FlightRecorder(size=64)
        sp = mod.FlightSpool(str(tmp_path / f"{name}.spool"), rec, node="n")
        sp.run_id = "0badcafe"
        steps(rec, [1, 2])
        sp.flush()
        rec.record("step", height=3, step="Propose", round=0)
        sp.close()
        out = []
        for ln in open(tmp_path / f"{name}.spool").read().splitlines():
            d = json.loads(ln)
            out.append({k: v for k, v in d.items()
                        if k not in ("mono_ns", "wall_ns", "t_ns")})
        lines[name] = out
    assert lines["port"] == lines["jax"]
    assert [d.get("type") for d in lines["port"]].count("anchor") == 2


def test_spool_run_id_is_an_argument(tmp_path):
    rec = ptracing.FlightRecorder(size=64)
    sp = ptracing.FlightSpool(str(tmp_path / "r.spool"), rec, node="n", run_id="feedf00d")
    drawn = ptracing.FlightSpool(str(tmp_path / "d.spool"), rec, node="n")
    assert sp.run_id == "feedf00d"
    assert len(drawn.run_id) == 8 and int(drawn.run_id, 16) >= 0
    rec.record("step", height=1, step="Propose")
    sp.close()
    drawn.close()
    assert '"run":"feedf00d"' in open(tmp_path / "r.spool").read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_tail_keeps_the_retained_suffix(writer, tmp_path):
    mod = MODS[writer]
    path = str(tmp_path / "flight.spool")
    rec = mod.FlightRecorder(size=4096)
    sp = mod.FlightSpool(path, rec, node="torn")
    steps(rec, range(1, 6))
    sp.flush()
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 7)
    dump = read_both(path)
    assert dump["torn"] == 1 and len(dump["events"]) >= 5 * 5 - 1
    assert ptracing.span_report(dump["events"], dropped=dump["dropped"])["bad"] == {}
    with open(path, "ab") as f:
        f.write(b"\n\xff\xfe{{{ not json\n")
    dump2 = read_both(path)
    assert dump2["torn"] == 2 and len(dump2["events"]) == len(dump["events"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rotation_bounds_disk_and_reports_the_dropped_prefix(writer, tmp_path):
    mod = MODS[writer]
    path = str(tmp_path / "flight.spool")
    rec = mod.FlightRecorder(size=1 << 16)
    cap = 16 * 1024
    sp = mod.FlightSpool(path, rec, size_limit=cap, node="rot")
    for h in range(1, 200):
        steps(rec, [h])
        sp.flush()
    sp.close()
    assert sum(os.path.getsize(p) for p in ptracing.spool_paths(path)) <= cap
    dump = read_both(path)
    assert dump["dropped"] > 0 and dump["events"]
    assert ptracing.span_report(dump["events"], dropped=dump["dropped"])["bad"] == {}
    assert 198 in ptracing.step_chains(dump["events"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ring_wrap_between_flushes_is_accounted(writer, tmp_path):
    mod = MODS[writer]
    rec = mod.FlightRecorder(size=8)
    sp = mod.FlightSpool(str(tmp_path / "w.spool"), rec, node="w")
    for i in range(30):
        rec.record("x", i=i)
    sp.flush()
    for i in range(30):
        rec.record("y", i=i)
    sp.flush()
    sp.close()
    dump = read_both(str(tmp_path / "w.spool"))
    assert len(dump["events"]) == 16 and dump["writer_lost"] == 22
    assert dump["dropped"] == 60 - 16


@pytest.mark.parametrize("writers", [("port", "jax"), ("jax", "port")])
def test_restart_appends_a_run_and_replay_returns_the_newest(writers, tmp_path):
    """One spool file, two sessions (a clean stop, then a SIGKILL), each by
    another package: both readers return the crashing session."""
    path = str(tmp_path / "flight.spool")
    first, second = (MODS[w] for w in writers)
    rec1 = first.FlightRecorder(size=4096)
    sp1 = first.FlightSpool(path, rec1, node="boot1")
    steps(rec1, range(1, 6))
    sp1.flush()
    sp1.close()
    rec2 = second.FlightRecorder(size=4096)
    sp2 = second.FlightSpool(path, rec2, node="boot2")
    steps(rec2, range(100, 103))
    sp2.flush()
    dump = read_both(path)
    assert dump["runs"] == 2 and dump["node"] == "boot2"
    assert {e.get("height") for e in dump["events"] if e["kind"] == "step"} == {100, 101, 102}
    assert len(dump["events"]) == len(rec2.events())
    solo = read_both(path + ".none")
    assert solo["events"] == [] and solo["runs"] == 0


def test_record_unchanged_with_a_spool_attached(tmp_path):
    """The spool reads the ring from its flushes only: a recorder with one
    attached records the same events, and record() stays under the JAX
    package's 5 us budget."""
    plain, spooled = ptracing.FlightRecorder(size=8192), ptracing.FlightRecorder(size=8192)
    sp = ptracing.FlightSpool(str(tmp_path / "hot.spool"), spooled, node="hot")
    n = 20_000
    t0 = time.perf_counter()
    for i in range(n):
        spooled.record("step", height=i, step="Propose", round=0)
    per_event = (time.perf_counter() - t0) / n
    for i in range(n):
        plain.record("step", height=i, step="Propose", round=0)
    assert per_event < 5e-6, f"record() with a spool attached took {per_event * 1e6:.2f} us"
    assert sp.flush() == 8192
    sp.close()

    def strip(evs):
        return [{k: v for k, v in e.items() if k != "t_ns"} for e in evs]

    assert strip(spooled.events()) == strip(plain.events())
    assert type(spooled).record is ptracing.FlightRecorder.record


def test_idle_flush_writes_nothing(tmp_path):
    path = str(tmp_path / "idle.spool")
    rec = ptracing.FlightRecorder(size=64)
    sp = ptracing.FlightSpool(path, rec, node="idle")
    rec.record("step", height=1, step="Propose")
    assert sp.flush() == 1
    size = os.path.getsize(path)
    assert sp.flush() == 0
    sp._group.flush()
    assert os.path.getsize(path) == size
    sp.close()


def test_crash_hooks_flush_on_excepthook(tmp_path):
    path = str(tmp_path / "hook.spool")
    rec = ptracing.FlightRecorder(size=64)
    sp = ptracing.FlightSpool(path, rec, node="hook")
    before = sys.excepthook
    sp.install_crash_hooks()
    try:
        rec.record("step", height=1, step="Propose")
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert len(read_both(path)["events"]) == 1
    finally:
        sp.close()
    assert sys.excepthook is before


def test_two_spools_crash_hooks_are_independent(tmp_path):
    rec_a, rec_b = ptracing.FlightRecorder(size=64), ptracing.FlightRecorder(size=64)
    sp_a = ptracing.FlightSpool(str(tmp_path / "a.spool"), rec_a, node="a")
    sp_b = ptracing.FlightSpool(str(tmp_path / "b.spool"), rec_b, node="b")
    before = sys.excepthook
    sp_a.install_crash_hooks()
    sp_b.install_crash_hooks()
    try:
        sp_a.close()
        assert sys.excepthook is sp_b._hook_fn
        rec_b.record("step", height=1, step="Propose")
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert len(read_both(str(tmp_path / "b.spool"))["events"]) == 1
        assert read_both(str(tmp_path / "a.spool"))["events"] == []
        # A's hook object stays in B's chain (A was not on top when it
        # closed); the chain ends in the hook installed before both
        assert sp_b._prev_excepthook is sp_a._hook_fn and sp_a._prev_excepthook is before
    finally:
        sp_b.close()
        sys.excepthook = before
