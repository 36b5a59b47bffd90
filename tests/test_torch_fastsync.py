"""The port's fast-sync parts (tendermint_tpu_torch/fastsync: Scheduler,
Processor, verify_commit_run) against the JAX package's, and phase 7 of
chip_smoke.py (replay from sqlite stores across a set rotation) end to end
at 7 validators on the CPU.

The state machines take the same seeded event sequences to the same
outputs and states.  verify_commit_run runs one batch mixing a good pair, a
corrupted signature, a wrong block id, a size mismatch and a wrong height:
the port's on its flat BatchVerifier (the kernels' plain versions), the
JAX package's on its host hook; the verdicts must be equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm

from test_torch_chain_types import CHAIN, JAX, PORT, ROTATE_AT, chain, outcome

torch.set_num_threads(1)

PEERS = ["p0", "p1", "p2"]


def _scheduler_trace(ns, seed):
    """A seeded event sequence through ns.Scheduler; every output and the
    state after each event."""
    rng = np.random.default_rng(seed)
    s = ns.Scheduler(1, max_pending_per_peer=3, max_total_pending=8, request_timeout=5.0)
    trace, now = [], 0.0
    for _ in range(150):
        now += float(rng.integers(0, 3))
        op = int(rng.integers(0, 9))
        peer = PEERS[int(rng.integers(0, len(PEERS)))]
        h = int(rng.integers(1, 16))
        if op == 0:
            s.add_peer(peer)
            out = None
        elif op == 1:
            base = int(rng.integers(0, 3))
            out = s.set_peer_range(peer, base, base + int(rng.integers(0, 15)))
        elif op == 2:
            out = s.next_requests(now)
            for p, hh in out:
                s.mark_requested(p, hh, now)
        elif op == 3:
            out = s.block_received(peer, h)
        elif op == 4:
            out = s.no_block(peer, h)
        elif op == 5:
            out = outcome(lambda: s.block_processed(s.height if rng.random() < 0.8 else h))
        elif op == 6:
            out = s.block_invalid(h)
        elif op == 7 and rng.random() < 0.3:
            out = s.remove_peer(peer)
        else:
            out = (s.is_caught_up(), s.only_tip_outstanding(), s.max_peer_height())
        state = (s.height, dict(s.pending), dict(s.received),
                 {k: (p.height, p.base, sorted(p.pending)) for k, p in s.peers.items()})
        trace.append((op, out, state))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_jax(seed):
    ours, theirs = _scheduler_trace(PORT, seed), _scheduler_trace(JAX, seed)
    assert ours == theirs
    assert any(op == 2 and out for op, out, _ in ours)


@pytest.mark.parametrize("seed", [0, 1])
def test_processor_matches_jax(seed):
    def trace(ns):
        rng = np.random.default_rng(seed)
        blocks = chain(ns)["blocks"]
        p = ns.Processor(1)
        out = []
        for _ in range(80):
            op = int(rng.integers(0, 5))
            h = int(rng.integers(1, len(blocks) + 1))
            if op == 0:
                p.add_block(h, blocks[h], f"peer{h % 2}")
                r = None
            elif op == 1:
                pair = p.peek_two()
                r = None if pair is None else (pair[0].height, pair[1].height)
                if pair is not None and rng.random() < 0.7:
                    p.pop_processed()
            elif op == 2:
                r = p.drop_invalid()
            elif op == 3:
                r = p.drop_heights([h, h + 1])
            else:
                r = p.pending_range()
            out.append((op, r, p.height, sorted(p.blocks)))
        return out

    assert trace(PORT) == trace(JAX)


def _run_pairs(ns):
    """(block_id, height, commit) pairs on set A: good, a flipped
    signature, a wrong block id, a size mismatch, a wrong height, good."""
    c = chain(ns)
    ids, commits = c["ids"], c["commits"]
    flipped = list(commits[2].signatures)
    sig = bytearray(flipped[3].signature)
    sig[5] ^= 0x10
    flipped[3] = dataclasses.replace(flipped[3], signature=bytes(sig))
    bad_sig = ns.Commit(2, 0, ids[2], flipped)
    short = ns.Commit(3, 0, ids[3], list(commits[3].signatures[:-1]))
    wrong_id = ns.BlockID(b"\x09" * 32, ids[3].parts_header)
    return c["states"][0].validators, [
        (ids[1], 1, commits[1]), (ids[2], 2, bad_sig), (wrong_id, 3, commits[3]),
        (ids[3], 3, short), (ids[3], 4, commits[3]), (ids[ROTATE_AT - 1], ROTATE_AT - 1,
                                                       commits[ROTATE_AT - 1])]


def test_verify_commit_run_matches_jax():
    vals, pairs = _run_pairs(PORT)
    jvals, jpairs = _run_pairs(JAX)
    bv = bvm.BatchVerifier(device="cpu").install()
    try:
        ours = PORT.verify_commit_run(vals, CHAIN, pairs)
        assert bv.last_dispatch["path"] == "device"
        # one flat batch: every signature of the structurally sound pairs
        assert bv.last_dispatch["n"] == sum(len(c.signatures) for _, _, c in pairs[:2] + pairs[-1:])
    finally:
        batch_hook.set_verifier(None)
    theirs = JAX.verify_commit_run(jvals, CHAIN, jpairs)
    assert ours == theirs == [True, False, False, False, False, True]
    # what is no commit at all fails as in the JAX package (aggregate
    # commits: tests/test_torch_agg_commit.py)
    assert outcome(lambda: PORT.verify_commit_run(vals, CHAIN, [(pairs[0][0], 1, object())])) \
        == outcome(lambda: JAX.verify_commit_run(jvals, CHAIN, [(jpairs[0][0], 1, object())]))


def test_phase7_replay_end_to_end_on_cpu(monkeypatch):
    """chip_smoke.py phase 7 at 7 validators, 2 replaced at height 7: 12
    pair checks (table misses at 1 and 7), two cross-height runs and the
    flipped-signature case, all checked inside the phase."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "REPLAY_ROTATE", 2)
    keys = cs.make_keys(7)
    launches = cs.phase_replay(keys, "cpu", torch.device("cpu"))
    assert set(launches) == set(cs.KERNELS)
    assert batch_hook.get_indexed_verifier() is None
