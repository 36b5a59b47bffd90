"""chip_smoke.py phase 12 (a third node joins phase 11's chain by state
sync: A and B restart from their homes with RPC on, C restores a snapshot
verified through A's and B's RPC, fast-syncs the tail and follows) end to
end at 7 validators on the CPU, after phase 11's rehearsal, the kernels'
plain versions behind every node's engine.  A and B run in this process
here; on the card they run through the CLI, each in its own process.
Every check is inside the phase; this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


def test_phase12_statesync_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ABCI_TXS", 20)
    monkeypatch.setattr(cs, "ABCI_CORRUPT", 10)
    keys = cs.make_keys(7)
    net = cs.phase_net(keys, "cpu", torch.device("cpu"), b_inproc=True, keep_homes=True)["net"]
    assert os.path.isdir(net["a"][0]) and os.path.isdir(net["b"][0])
    out = cs.phase_statesync(keys, "cpu", torch.device("cpu"), net, inproc=True)
    # snapshots at 2, 4 and 6, the app keeps 4 and 6; 6 cannot verify (no
    # header 7 on a chain that stands still), so C restores 4
    assert out["snapshot"] == 4
    # the restored sets carry ValidatorSet(vals)'s priorities (ROADMAP 3.6)
    assert out["priorities"] > 0
    # on the CPU nothing launches a kernel
    assert out["stages"]["all"] == dict.fromkeys(cs.KERNELS, 0)
    # the homes are gone, and every node gave the hooks back
    assert not os.path.exists(net["a"][0])
    assert batch_hook.get_indexed_verifier() is None
