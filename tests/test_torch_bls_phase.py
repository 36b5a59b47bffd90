"""chip_smoke.py phase 20 (BLS12-381 keys on a mixed set) end to end on the
CPU at 8 validators, the kernels' plain versions behind the engine: a home
written by `init --key-type bls12381` (its genesis entry carrying its proof
of possession), 3 more bls12381 and 4 ed25519 validators through phase 9's
consensus core (heights 1-4, a round change, our proposal, a restart from
the WAL) with `[consensus] bls_aggregate_commits` at its default, every
stored commit a per-vote Commit, and each height's commit through
verify_commit and verify_commit_trusting, each one flat batch of its
ed25519 signatures.  Every check is inside the phase; this test holds what
it returns.  Also the plumbing that runs a phase in a process of its own
beside the others on the card (`PhaseChild`), with phase 19 (a) on the CPU,
and the children that run phases 6-8 and 14 (their phases stubbed).
"""

import os

import pytest
import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


def test_phase20_mixed_bls_chain_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "BLS_VALIDATORS", 8)
    monkeypatch.setattr(cs, "BLS_MEMBERS", 4)
    monkeypatch.setattr(cs, "BLS_TXS", 10)
    out = cs.phase_bls_chain("cpu", torch.device("cpu"))
    # the BLS members' votes and commit signatures verified on the host: 3
    # peers' prevotes and precommits over 5 rounds (a flipped precommit
    # frame each), the LastCommits, the commits checked after the run
    assert out["verifies"]["BlsPubKey"] > 2 * 3 * 5
    # each height's commit: one flat batch of its ed25519 signatures (4, or
    # fewer where a precommit came late)
    assert len(out["flat"]) == cs.CS_HEIGHTS and all(0 < n <= 4 for n in out["flat"])
    # on the CPU nothing launches a kernel
    assert out["launches"] == dict.fromkeys(cs.KERNELS, 0)
    assert batch_hook.get_verifier() is not None  # the host default, reset
    assert batch_hook.get_indexed_verifier() is None


def test_a_phase_runs_in_a_process_of_its_own_on_cpu(monkeypatch):
    """The run's children (chip_smoke.PhaseChild, which phases 6-8, 14,
    18 (a), 19 (a), 20 and 21 use on the card): phase 19 (a) at 8 sr25519 validators in a
    process of its own, its output tagged back, its result (launches read
    in that process, host verifies) returned by join(); a child that fails
    makes join() raise with its last lines."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    kid = cs.PhaseChild("19 a", "child_phase", "19 a", "cpu", None, "cpu",
                        {"KT_SR_VALIDATORS": 8, "KT_SR_TXS": 5})
    out = kid.join()
    assert out["launches"] == out["node"] == dict.fromkeys(cs.KERNELS, 0)
    assert out["verifies"]["Sr25519PubKey"] > 2 * 7 * 5
    assert any("heights 1-4 on sr25519 keys" in line for line in kid.tail)
    bad = cs.PhaseChild("x", "child_phase", "no such phase", "cpu", None, "cpu")
    with pytest.raises(AssertionError, match="no phase 'no such phase'"):
        bad.join()


def test_phases_6_to_8_and_14_run_as_children_with_their_own_pick(monkeypatch):
    """child_phase's "6 7 8" and "14", which run beside phases 9, 10 (a) and
    15 on the card: each phase runs with its launch checks, a check takes
    the process's own auto-profile pick where the process has profiled (the
    parent's otherwise), phase 4's times reach phase 6, and the result gives
    each phase's launches.  The phases are stubbed with launch counts of a
    card run: on the CPU nothing launches, so their checks cannot pass."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs
    from tendermint_tpu_torch.crypto import batch_verifier as bvm

    names = ("ed25519_ladder", "ed25519_window_tables", "ed25519_tabulated")
    card = {"6": (18, 4, 13), "7": (3, 2, 13), "8": (7, 2, 18), "14": (277, 1, 8)}
    now, seen = {"phase": None}, {}
    monkeypatch.setattr(cs, "launch_counts", lambda zero=False, add=None: dict(
        zip(names, card[now["phase"]] if now["phase"] else (0, 0, 0))))
    monkeypatch.setattr(cs, "make_keys", lambda n, *a, **k: [])
    by_part = {"ed25519_tabulated": 3, "ed25519_ladder": 1, "ed25519_window_tables": 2}

    def light(keys, card_, dev, report):
        now["phase"] = "6"
        seen["ms"] = {k: r.get("ms") for k, r in report.items()}
        return None, {"ed25519_ladder": 5}

    def replay(keys, card_, dev):
        now["phase"] = "7"
        return {"ed25519_tabulated": 3, "ed25519_ladder": 0}

    def abci(keys, card_, dev):
        now["phase"] = "8"
        return {"flushes": {"ed25519_ladder": 2}, "a": by_part, "b": by_part, "c3": by_part}

    def boundary(keys, card_, dev):
        now["phase"] = "14"
        return {"validate_blocks": 8, "hits": 7, "declines": 1, "frames": 6,
                "light": {"launches": {}, "paths": {}, "tables": {}}}

    monkeypatch.setattr(cs, "phase_light", light)
    monkeypatch.setattr(cs, "phase_replay", replay)
    monkeypatch.setattr(cs, "phase_abci", abci)
    monkeypatch.setattr(cs, "phase_boundary", boundary)
    monkeypatch.setattr(bvm, "tabulated_profiles", {})
    ms = {"ed25519_ladder": 1.39, "ed25519_tabulated": 0.77}
    out = cs.child_phase("6 7 8", "cpu", "ed25519_tabulated", "cpu", None, ms)
    assert out == {n: {p: card[p][i] for p in ("6", "7", "8")} for i, n in enumerate(names)}
    assert seen["ms"] == {**ms, "ed25519_window_tables": None}
    assert cs.child_phase("14", "cpu", "ed25519_tabulated", "cpu") == dict(zip(names, card["14"]))
    # the process profiled the ladder faster: phase 7 (a)'s tabulated
    # launches no longer show the pick, though the parent picked the tables
    monkeypatch.setattr(bvm, "tabulated_profiles", {"card": {"tab_ms": 2.0, "ladder_ms": 1.0}})
    assert cs.process_pick("ed25519_tabulated") == "ed25519_ladder"
    with pytest.raises(AssertionError, match=r"pick \(ed25519_ladder\) was not launched in "
                                             r"phase 7 \(a\)"):
        cs.child_phase("6 7 8", "cpu", "ed25519_tabulated", "cpu", None, ms)
