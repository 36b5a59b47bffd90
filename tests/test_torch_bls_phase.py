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
beside the others on the card (`PhaseChild`), with phase 19 (a) on the CPU.
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
    assert out["launches"] == dict.fromkeys(
        ("ed25519_ladder", "ed25519_window_tables", "ed25519_tabulated"), 0)
    assert batch_hook.get_verifier() is not None  # the host default, reset
    assert batch_hook.get_indexed_verifier() is None


def test_a_phase_runs_in_a_process_of_its_own_on_cpu(monkeypatch):
    """The run's children (chip_smoke.PhaseChild, which phases 18 (a), 19 (a)
    and 20 use on the card): phase 19 (a) at 8 sr25519 validators in a
    process of its own, its output tagged back, its result (launches read
    in that process, host verifies) returned by join(); a child that fails
    makes join() raise with its last lines."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    kid = cs.PhaseChild("19 a", "child_phase", "19 a", "cpu", None, "cpu",
                        {"KT_SR_VALIDATORS": 8, "KT_SR_TXS": 5})
    out = kid.join()
    assert out["launches"] == out["node"] == dict.fromkeys(
        ("ed25519_ladder", "ed25519_window_tables", "ed25519_tabulated"), 0)
    assert out["verifies"]["Sr25519PubKey"] > 2 * 7 * 5
    assert any("heights 1-4 on sr25519 keys" in line for line in kid.tail)
    bad = cs.PhaseChild("x", "child_phase", "no such phase", "cpu", None, "cpu")
    with pytest.raises(AssertionError, match="no phase 'no such phase'"):
        bad.join()
