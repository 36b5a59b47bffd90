"""chip_smoke.py phase 10 (a) (node wiring: one validator of a chain run as
a Node from its home directory, through a validator-set rotation that
_valset_watch follows, stopped mid-height and resumed from the same home
by a second node) end to end at 7 validators on the CPU, the kernels'
plain versions behind the node's engine and the real TimeoutTicker
(timeout_commit 1 s).  Every check is inside the phase; this test holds
what it returns.  Phase 10 (b), the CLI's `node`, needs the card.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.libs import loopprof

torch.set_num_threads(1)


def test_phase10_node_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ABCI_TXS", 20)
    monkeypatch.setattr(cs, "ABCI_CORRUPT", 10)
    monkeypatch.setattr(cs, "NODE_ROTATE", 2)
    out = cs.phase_node(cs.make_keys(7), "cpu", torch.device("cpu"))
    # validate_block at prevote, lock, finalize and in apply_block: 4 per
    # height at 2-4; at 5, 2 before the stop and 4 after (the replayed
    # proposal, lock, finalize, apply_block)
    assert out["validate_blocks"] == 18
    # the first node declines once (the genesis set's first check); the
    # restarted node's empty TableCache declines set B at least once
    assert out["declines"][0] == 1 and out["declines"][1] >= 1
    assert out["hits"] == 18 - sum(out["declines"])
    assert out["tables"] == ["table-build", "table-rebuild", "table-build"]
    assert out["window_builds"] == 0  # the CPU never engages the tables
    # one prevote and one precommit frame per height (6 peers), 5 heights
    assert out["frames"] == 10
    assert batch_hook.get_indexed_verifier() is None
    assert loopprof.active() is None
