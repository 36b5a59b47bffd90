"""chip_smoke.py phase 13 (a node from a stock home: D, made by the port's
`init` with one seed added, discovers phase 11's chain by PEX from A,
fast-syncs it, streams NewBlock over /websocket, then serves 8
light-client tenants from its gateway) end to end at 7 validators on the
CPU, after the rehearsals of phases 11 and 12 (run with keep_running, so A,
B and C are still up), the kernels' plain versions behind every node's
engine.  A and B run in this process here; on the card they run through
the CLI, each in its own process.  Every check is inside the phase,
phase 12's included; this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


def test_phase13_stock_home_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ABCI_TXS", 20)
    monkeypatch.setattr(cs, "ABCI_CORRUPT", 10)
    keys = cs.make_keys(7)
    cpu = torch.device("cpu")
    net = cs.phase_net(keys, "cpu", cpu, b_inproc=True, keep_homes=True)["net"]
    ss = cs.phase_statesync(keys, "cpu", cpu, net, inproc=True, keep_running=True)
    assert ss["snapshot"] == 4 and ss["live"]["c"].is_running
    out = cs.phase_stockhome(keys, "cpu", cpu, ss)
    # phase 12's checks ran at the end: C restored the snapshot at 4
    assert out["ss"]["snapshot"] == 4
    # D's fast sync checked its pairs through its own TableCache: the first
    # declined (the engine was warming up), later ones may hit
    assert out["declines"] >= 1
    # on the CPU nothing launches a kernel
    for stage in out["stages"].values():
        assert stage == dict.fromkeys(cs.KERNELS, 0)
    # every home is gone and every node gave the hooks back
    assert not os.path.exists(net["a"][0])
    assert batch_hook.get_indexed_verifier() is None
