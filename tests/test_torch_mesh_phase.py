"""chip_smoke.py phase 23 (the verify mesh) rehearsed on the CPU at a small
size: the mesh probe and the engine with [tpu] mesh = "on" (one shard
here), then 30 validators on 2 virtual CPU shards against the one-device
path (the commit, 29 signatures, a flipped signature in each shard's
slice, the chunked single shot at a chunk of 10, the flat batch) and both
folds at 24 points on 2 shards and on 3 (unsharded).  The plain versions
count no launch, so every count stays 0."""

import os

import torch

from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase23_rehearsed_on_cpu(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "N_VALIDATORS", 30)
    monkeypatch.setattr(cs, "FOLD_POINTS", 24)
    monkeypatch.setattr(cs, "MESH_SHARDS", 2)
    monkeypatch.setattr(bvm, "_CHUNK", 10)
    out = cs.phase_mesh("cpu", torch.device("cpu"))
    assert out["probe_shards"] == 1
    assert out["launches"] == dict.fromkeys(cs.KERNELS, 0)
    labels = {k.rsplit(" [", 1)[1][:-1] for k in out["rows"]}
    assert labels == {"one card", "2 shards", "3 shards"}
    assert {k.rsplit(" [", 1)[0] for k in out["rows"]} == {
        "the commit", "29 signatures", "a flipped signature at [7, 23]", "chunked", "flat",
        *cs.FOLD_KERNELS}
    # the engine phase (a) built and the hooks (b) installed are gone
    assert batch_hook.get_verifier() is batch_hook.host_batch_verify
    assert batch_hook.get_indexed_verifier() is None
