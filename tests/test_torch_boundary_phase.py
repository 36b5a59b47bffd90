"""chip_smoke.py phase 14 (a validator across its process boundaries: its
app behind the ABCI socket in `python -m tendermint_tpu_torch.abci_cli
kvstore`, its key in a remote signer process, /metrics on its listener, a
light proxy in front of its RPC, `abci_cli info` and `query` against the
app, the signer harness against a second signer) end to end at 7
validators on the CPU, the kernels' plain versions behind the node's
engine and the real TimeoutTicker.  The app server, both signers, the
harness and the one-shot abci_cli commands are real subprocesses here too;
the light proxy runs in this process as a LightProxy on the node's hooks
(the `light` command exits 1 without a card).  Every check is inside the
phase; this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.libs import loopprof

torch.set_num_threads(1)


def test_phase14_process_boundaries_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ABCI_TXS", 20)
    monkeypatch.setattr(cs, "ABCI_CORRUPT", 10)
    out = cs.phase_boundary(cs.make_keys(7), "cpu", torch.device("cpu"), inproc_light=True)
    # validate_block on heights 2 and 3; the genesis set's first check
    # declines (the engine warms up), the later ones hit its table
    assert out["declines"] == 1 and out["hits"] == out["validate_blocks"] - 1
    assert out["validate_blocks"] >= 2
    # one prevote and one precommit frame per height (6 peers), 3 heights
    assert out["frames"] == 6
    # on the CPU no stage launches a kernel
    assert set(out["stages"]) == {"start", "heights", "light", "after"}
    for stage in out["stages"].values():
        assert stage == dict.fromkeys(cs.KERNELS, 0)
    assert batch_hook.get_indexed_verifier() is None
    assert loopprof.active() is None
