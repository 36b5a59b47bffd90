"""chip_smoke.py phase 15 (transactions from outside: the app over ABCI gRPC
in `python -m tendermint_tpu_torch.abci_cli --abci grpc kvstore`, a
`tools.loadgen` firehose at the node's RPC, a BroadcastAPIClient on
`rpc.grpc_laddr` after the firehose, `abci_cli --abci grpc info` and
`query` after the heights) end to end at 7 validators on the CPU, the kernels' plain
versions behind the node's engine and the real TimeoutTicker.  The app
server, loadgen and the one-shot abci_cli commands are real subprocesses
here too.  On the CPU each plain ladder call takes about a second, so the
firehose is slowed to 20 tx/s and the engine keeps the JAX rule of 16 for
the host path (on the card every signed-tx flush verifies there).  Every
check is inside the phase; this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.libs import loopprof

torch.set_num_threads(1)


def test_phase15_transactions_from_outside_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "GR_FIRST", 8)
    monkeypatch.setattr(cs, "GR_RATE", 20)
    monkeypatch.setattr(cs, "GR_LOAD_S", 6.0)
    monkeypatch.setattr(cs, "GR_MIN_DEVICE_BATCH", 16)
    out = cs.phase_grpc(cs.make_keys(7), "cpu", torch.device("cpu"))
    # validate_block on heights 2-4; the genesis set's first check declines
    # (the engine warms up), the later ones hit its table
    assert out["declines"] == 1 and out["hits"] == out["validate_blocks"] - 1
    assert out["validate_blocks"] >= 1
    # one prevote and one precommit frame per height (6 peers), 4 heights
    assert out["frames"] == 8
    # the signed-tx lane flushed; loadgen's txs are in blocks and the pool
    assert out["flushes"] >= 1 and out["a_blocks"] >= cs.GR_FIRST
    assert out["ping"][0] == {}
    # on the CPU no stage launches a kernel
    assert set(out["stages"]) == {"start", "heights", "after"}
    for stage in out["stages"].values():
        assert stage == dict.fromkeys(cs.KERNELS, 0)
    assert batch_hook.get_indexed_verifier() is None
    assert loopprof.active() is None
