"""chip_smoke.py phase 11 (two port nodes of a chain over TCP: node A built
by default_new_node from its home, four relay switches in a process of
their own standing in for the other validators, node B fast-syncing from A
and then following it through A's consensus reactor) end to end at 7
validators on the CPU, the kernels' plain versions behind both nodes'
engines and the real TimeoutTicker (timeout_commit 1 s).  Node B runs in
this process here, on A's crypto.batch hooks; on the card it runs through
the CLI in a subprocess.  Every check is inside the phase; this test holds
what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.libs import loopprof

torch.set_num_threads(1)


def test_phase11_net_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
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
    assert batch_hook.get_indexed_verifier() is None
    assert loopprof.active() is None
