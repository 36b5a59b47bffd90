"""chip_smoke.py phase 11 (two port nodes of a chain over TCP: node A built
by default_new_node from its home, four relay switches in a process of
their own standing in for the other validators, node B fast-syncing from A
and then following it through A's consensus reactor) end to end at 7
validators on the CPU, the kernels' plain versions behind both nodes'
engines and the real TimeoutTicker (timeout_commit 1 s).  Node B runs in
this process here, on A's crypto.batch hooks; on the card it runs through
the CLI in a subprocess.  Every check is inside the phase; this test holds
what it returns.

Phase 16 (a node's flight record) runs inside phase 11, so this is its
CPU rehearsal too: every tool runs as `python -m tendermint_tpu_torch
...` against A and B with their spools on.  With B in this process the
rehearsal drops B's spool without its final flush (as SIGKILL would) and
`debug kill` kills a stand-in child; on the card `debug kill` SIGKILLs
the CLI node B.  The phase's reading of broken-chain reports (ROADMAP
3.10: B's catch-up heights) is held against the CLI's own text.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.libs import loopprof
from tendermint_tpu_torch.libs import tracing as ptracing

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase11_net_end_to_end_on_cpu(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ABCI_TXS", 20)
    monkeypatch.setattr(cs, "ABCI_CORRUPT", 10)
    out = cs.phase_net(cs.make_keys(7), "cpu", torch.device("cpu"), b_inproc=True)
    # A's validate_block at prevote, lock, finalize and in apply_block, 4
    # per height at 2-6; the genesis set's first check declines.  B in this
    # process leaves the crypto.batch hooks A's (NetB), so A's TableCache
    # serves every later check, as on the card
    assert out["validate_blocks"] == 20
    assert out["declines"] == 1 and out["hits"] == 19
    # A's TableCache builds the genesis set's table; B's checks reach it
    # through the hooks, so B's cache builds none
    assert out["tables"] == ["table-build"]
    # 7-validator frames hold fewer than 16 votes: none takes verify_direct
    assert out["frames"] == 0
    assert "MB/s" in out["link"]
    # phase 16: A five complete chains (heights 2-6) with every stage over
    # each; B at least FX_CHAINS; both merged with a landmark or measured
    # offset; B's replay one run, whole, holding its dispatches
    fx = out["fx"]
    assert fx["A"]["chains"] == 5 and fx["A"]["caught_up"] == {}
    assert set(fx["A"]["budget"]["stages"]) == set(ptracing.BUDGET_STAGES)
    assert min(st["n"] for st in fx["A"]["budget"]["stages"].values()) >= 4
    assert fx["B"]["chains"] >= cs.FX_CHAINS and fx["A"]["net"] and fx["B"]["net"]
    assert [n for n, *_ in fx["offsets"]] == ["a", "b"]
    assert all(src != "anchor" for _, _, src, _ in fx["offsets"])
    rep = fx["replay"]
    assert rep["runs"] == 1 and rep["torn"] == 0 and rep["writer_lost"] == 0
    assert 0 <= rep["anchor_ms"] <= 1000 and rep["compared"] > 0 and rep["bytes"] > 0
    assert len(rep["complete"]) >= cs.FX_CHAINS and rep["dispatch"] > 0
    assert fx["rc_b"] == -9  # the stand-in child
    assert fx["launches"] == {"ed25519_ladder": 0, "ed25519_window_tables": 0,
                              "ed25519_tabulated": 0}  # no card here
    assert batch_hook.get_indexed_verifier() is None
    assert loopprof.active() is None


def test_broken_chain_reports_are_read_as_the_cli_prints_them(monkeypatch):
    """Phase 16 reads `trace --check`'s failure line and trace-net's
    failure lines; only B's heights before NET_JOIN_AT that lack PROPOSE
    and/or PREVOTE count as caught up (ROADMAP 3.10)."""
    from tendermint_tpu_torch.libs.tracemerge import check

    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    events = []
    for h in range(1, 7):
        for step in ("NewHeight", "NewRound", "Propose", "Prevote", "Precommit", "Commit"):
            if not (h == 3 and step == "Prevote"):
                events.append({"seq": len(events), "t_ns": len(events), "kind": "step",
                               "height": h, "round": 0, "step": step})
    rep = ptracing.span_report(events)
    line = (f"trace check FAILED: {rep['interior']} interior heights, "
            f"complete={len(rep['complete'])} truncated={len(rep['truncated'])} "
            f"broken chains: {rep['bad']}")
    assert cs.fx_broken(line) == {3: ["Prevote"]} and cs.fx_caught_up({3: ["Prevote"]})
    dump = {"node": "b", "events": events, "dropped": 0}
    failures = check([dump], {"heights": {}, "hash_mismatch_heights": []},
                     require_attribution=False)
    assert failures[0] == "b: broken span chains {3: ['Prevote']}"
    assert cs.fx_failures(failures) == failures[1:]
    assert cs.fx_failures(["a: broken span chains {3: ['Prevote']}"]) != []
    assert not cs.fx_caught_up({cs.NET_JOIN_AT: ["Propose"]})
    assert not cs.fx_caught_up({2: ["Precommit"]})
    assert cs.fx_caught_up({2: ["Propose", "Prevote"]})
    assert cs.fx_caught_up({"3": ["Prevote"]}) and not cs.fx_caught_up({"5": ["Prevote"]})
