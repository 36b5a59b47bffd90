"""chip_smoke.py phase 19 (the other key types) end to end on the CPU at 16
validators, the kernels' plain versions behind the engine: (a) a home
written by `init --key-type sr25519`, 16 sr25519 validators through phase
9's consensus core (heights 1-4, a round change, our proposal, a restart
from the WAL), the chain's commits through verify_commit and
verify_commit_trusting, and the 2-of-3 multisig on the host; (b) a mixed
set of 11 ed25519, 3 sr25519, 1 secp256k1 and 1 bls12381 validators (the
BLS member's proof of possession through batch_pop_verify): the full
commit as one flat ladder batch of the 11 ed25519 signatures beside 5
host verifies,
one bad signature of each type, the ed25519 members' commit on
the indexed path, and verify_commit_trusting.  Every check is inside the
phase; this test holds what it returns.
"""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook

torch.set_num_threads(1)


def test_phase19_keytypes_end_to_end_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "KT_SR_VALIDATORS", 16)
    monkeypatch.setattr(cs, "KT_SR_TXS", 10)
    monkeypatch.setattr(cs, "KT_MIX_SR", 3)
    monkeypatch.setattr(cs, "KT_MIX_SECP", 1)
    monkeypatch.setattr(cs, "KT_MIX_BLS", 1)
    dev = torch.device("cpu")
    a = cs.phase_sr_chain("cpu", dev)
    # every sr25519 vote and commit verified on the host: 15 peers' prevotes
    # and precommits over 5 rounds (a flipped precommit frame each), the
    # LastCommits and the commits checked after the run
    assert a["verifies"]["Sr25519PubKey"] > 2 * 15 * 5
    assert a["launches"] == dict.fromkeys(cs.KERNELS, 0)
    keys = cs.make_keys(16)
    _, _, commit, _ = cs.build_commit(keys)
    b = cs.phase_mixed(keys, commit, "cpu", dev)
    assert b["flat_n"] == b["n_ed"] == 11
    checks = b["checks"]
    assert [c["paths"] for c in checks.values()] == (
        [[("device", 11)]] * 6 + [[("indexed", 11)]] * 2 + [[("device", 11)]])
    assert set(checks["1 full commit, verify_commit"]["host_ms"]) == {
        "Sr25519PubKey", "Secp256k1PubKey", "BlsPubKey"}
    assert batch_hook.get_verifier() is not None  # the host default, reset
    assert batch_hook.get_indexed_verifier() is None
