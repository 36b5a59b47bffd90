"""chip_smoke.py phase 9 (the consensus core: a validator node committing
heights 1-4 from peers' proposals and vote frames, changing round at 2,
proposing 3 itself, and recovering mid-height from its WAL and FilePV)
end to end at 7 validators on the CPU, the kernels' plain versions behind
the engine and the real TimeoutTicker (timeout_commit 1 s, timeout_propose
3 s).  Every check is inside the phase; this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


def test_phase9_consensus_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ABCI_TXS", 20)
    monkeypatch.setattr(cs, "ABCI_CORRUPT", 10)
    out = cs.phase_consensus(cs.make_keys(7), "cpu", torch.device("cpu"))
    # validate_block at prevote, lock, finalize and in apply_block: 4 per
    # height at 2-3, 6 at height 4 (two replayed by catchup_replay)
    assert cs.CS_HEIGHTS == 4
    assert out["validate_blocks"] == out["indexed_dispatches"] == 14
    # one prevote and one precommit frame per round (6 peers), 5 rounds
    assert out["frames"] == 10
    assert out["launches"] == dict.fromkeys(cs.KERNELS, 0)
    assert batch_hook.get_indexed_verifier() is None
