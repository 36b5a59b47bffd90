"""chip_smoke.py phase 18 (b), the JAX rotation rig
(networks/local/rotation_smoke.py) on 7 in-process port nodes on the
staking app, rehearsed on the CPU (the engine on, at a min_device_batch
that keeps every batch on the host path): growth 4 -> 7 through
InProcRig.valset and the DSL with a partition across the set change, the
twin's evidence committed, the epoch shift, the twin voted out, the live
ed25519 -> BLS12-381 migration of every validator (aggregate commits
engage on the uniform set and disengage when node 0 rotates back), a
fresh node fast-syncing the rotated history, lite2 bisecting from height 2
to the tip, and `loadgen --mode bank` against node 0's RPC.  Every check is inside the
phase; this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


def test_phase18b_rotation_rig_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    out = cs.phase_rotation("cpu", torch.device("cpu"))
    assert out["set_size_after_growth"] == 7 and out["set_size_after_leave"] == 6
    assert out["lite2_skip_across_rotation_ok"] and out["twin_evidence_height"] > 0
    assert out["epoch_rotation_observed"] % cs.RT_EPOCH == 0
    assert out["valset_update_events"] > 0 and out["table_rebuild_ok_events"] > 0
    assert out["fastsync_joiner_height"] >= out["epoch_rotation_observed"]
    # the BLS step: aggregation engages above the uniform height, folds on
    # node 0 until the rotation back, and disengages after it; nothing
    # dispatches to a kernel in the aggregate window
    assert out["bls_uniform_height"] <= out["agg_engaged_height"] <= out["agg_last_height"]
    assert out["agg_disengaged_height"] > out["agg_last_height"]
    assert out["bls_migration_height_gap"] == out["agg_engaged_height"] - out["bls_uniform_height"]
    assert out["dispatch_aggregate"] == {} and out["dispatch_before"]
    assert out["fastsync_joiner_height"] > out["agg_disengaged_height"]
    load = out["bank_load"]
    # fault 3.13 (ROADMAP 3): past each worker's first tx, its lane runs
    # ahead of the committed nonce
    assert load["accepted"] > 0 and load["reject_codes"].get("app:12", 0) > load["accepted"]
    assert batch_hook.get_indexed_verifier() is None
