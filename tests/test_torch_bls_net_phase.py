"""chip_smoke.py phase 21 (a uniformly BLS12-381 net, the JAX
networks/local/bls_smoke.py) end to end on the CPU: four port validators
from `testnet --key-type bls12381` at its default config (aggregation on,
the engine on), every stored commit below the tip an AggregateCommit on
every node and on `/commit`, a catch-up joiner through the `agg_commit`
lane and a fast-sync joiner whose commits then go through
verify_commit_run's one pairing product, and a validator's restart onto
its AggregateLastCommit.  Every check is inside the phase; this test holds
what it returns, and the commit judgement on its own.
"""

import base64
import os

import pytest
import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


@pytest.fixture
def cs(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke

    return chip_smoke


def test_phase21_bls_net_end_to_end_on_cpu(cs):
    out = cs.phase_bls_net("cpu", torch.device("cpu"))
    # commits 1 .. tip-1 on each of the four validators, all aggregate
    assert out["checked"] >= cs.BN_VALIDATORS * (cs.BN_HEIGHTS - 1)
    # in the block store's codec: one 96-byte signature and a bitmap
    # against a CommitSig of a 96-byte signature for each of 3 or 4 signers
    assert out["commit_bytes"] < 300 and out["per_vote_bytes"] > out["commit_bytes"] + 2 * 96
    assert out["verifies"]["batch_verify_aggregates"] == 1
    assert out["verifies"]["fast_aggregate_verify"] >= 1
    assert set(out["parts"]) == {"net", "commits", "joiners", "restart"}
    assert batch_hook.get_indexed_verifier() is None


def _commit(bits, signed, sig_len=96):
    signers = bits.to_bytes(4, "big") + bytes([sum(0x80 >> i for i in signed)])
    return {"height": 3, "round": 0, "agg_sig": {"@b": base64.b64encode(b"\x01" * sig_len).decode()},
            "signers": {"@b": base64.b64encode(signers).decode()}, "block_id": {}}


@pytest.mark.parametrize("commit, why", [
    ({**_commit(4, (0, 1, 2)), "signatures": []}, "per-vote"),
    (_commit(4, (0, 1)), "below \\+2/3"),
    (_commit(5, (0, 1, 2)), "below \\+2/3"),
    (_commit(4, (0, 1, 2), sig_len=95), "bad agg_sig"),
])
def test_the_commit_judgement_refuses_what_bls_smoke_refuses(cs, commit, why):
    cs.bn_check_commit(_commit(4, (0, 1, 2)), 4)
    with pytest.raises(AssertionError, match=why):
        cs.bn_check_commit(commit, 4)
