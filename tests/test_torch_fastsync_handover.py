"""A validator that is still fast-syncing must not be sent consensus
traffic it will drop (ROADMAP 3.15), in both packages on the same trigger.

Four validators at power 10: 0 and 1 start in consensus, 2 and 3 with fast
sync on behind a held gate (SWITCH_TO_CONSENSUS_INTERVAL at an hour).
Nodes 0 and 1 reach height 1 and prevote; with 2 of 4 prevotes they wait.

- The JAX reactor announces a fast-syncing node's round state when a peer
  connects (`add_peer`), so nodes 0 and 1 gossip their round-0 prevotes
  to 2 and 3 and mark them delivered; 2 and 3 drop them (`receive` while
  `wait_sync`).  After the gate opens, the handover's new_round_step is
  at the same height and round, the marks stay, and the net wedges at
  height 1: 2 and 3 at prevote lacking 0's and 1's prevotes, 0 and 1 at
  precommit with 2 of 4 precommits.  The fault is pinned here as the
  state it leaves, not as a timeout.
- The port announces its round state only at the handover, as the Go
  reactor's AddPeer does: nodes 0 and 1 hold their peers 2 and 3 at
  height 0 and send them nothing, and once the gate opens the net
  commits height 2.
"""

import asyncio

import pytest
import torch

import test_torch_net as tnet
from tendermint_tpu.fastsync import reactor as jfs
from tendermint_tpu_torch.fastsync import reactor as pfs

torch.set_num_threads(1)

EARLY, LATE = (0, 1), (2, 3)


async def _until(pred, timeout):
    async def loop():
        while not pred():
            await asyncio.sleep(0.02)

    await asyncio.wait_for(loop(), timeout)


def _marked_prevotes(node, peer) -> int:
    """Round-0 prevotes that `node` believes `peer` holds."""
    ps = node.consensus_reactor.peer_states.get(peer.node_key.id)
    bits = ps.prevotes.get(0) if ps is not None else None
    return bits.count() if bits is not None else 0


def _held_prevotes(node) -> int:
    votes = node.consensus.rs.votes
    vs = votes.prevotes(0) if votes is not None else None
    return vs.bit_array().count() if vs is not None else 0


@pytest.mark.parametrize("kind", ["jax", "port"])
async def test_a_net_leaving_fast_sync_in_two_groups(tmp_path, monkeypatch, kind):
    fs = jfs if kind == "jax" else pfs
    seeds = tnet._seeds(4, "handover")
    jg, pg = tnet._genesis(seeds)
    nodes = [tnet._node(kind, tmp_path, f"h{i}", s, jg, pg, fast_sync=i in LATE)
             for i, s in enumerate(seeds)]
    monkeypatch.setattr(fs, "SWITCH_TO_CONSENSUS_INTERVAL", 3600.0)
    try:
        for n in nodes:
            await n.start()
        await tnet._mesh(nodes)
        early = [nodes[i] for i in EARLY]
        late = [nodes[i] for i in LATE]
        # the early nodes' own round-0 prevotes are in
        await _until(lambda: all(_held_prevotes(n) >= 2 for n in early), 20.0)
        assert all(n.consensus_reactor.wait_sync for n in late)
        if kind == "jax":
            # the early nodes gossip their prevotes to the fast-syncing
            # ones and mark them delivered
            await _until(lambda: all(_marked_prevotes(e, x) >= 2 for e in early for x in late),
                         20.0)
        else:
            await asyncio.sleep(1.0)  # a gossip pass or more
            for e in early:
                for x in late:
                    ps = e.consensus_reactor.peer_states[x.node_key.id]
                    assert ps.height == 0 and _marked_prevotes(e, x) == 0
        monkeypatch.setattr(fs, "SWITCH_TO_CONSENSUS_INTERVAL", 1.0)
        await _until(lambda: all(not n.consensus_reactor.wait_sync and n.consensus.is_running
                                 for n in late), 20.0)
        if kind == "port":
            await tnet._wait_height(nodes, 2, 30.0)
            return
        # the wedge: the late nodes prevote but never hold +2/3 prevotes,
        # while the early nodes still mark the prevotes the late ones lack
        await _until(lambda: all(_held_prevotes(n) >= 2 for n in late), 20.0)
        await asyncio.sleep(2.0)  # many round timeouts of test_config
        assert all(n.block_store.height() == 0 for n in nodes)
        for x in late:
            assert x.consensus.rs.height == 1 and x.consensus.rs.round == 0
            assert _held_prevotes(x) == 2
            for e in early:
                assert _marked_prevotes(e, x) >= 2
    finally:
        await tnet._stop(nodes)
