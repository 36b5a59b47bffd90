"""A mixed network: two JAX `Node`s and two port `Node`s make one
4-validator chain at power 10 on 127.0.0.1 (memdb stores, timeout_commit
0.1 s), meshed over real TCP through each package's Transport,
SecretConnection and MConnection, as tests/test_consensus_net.py's
make_net builds its nets.  The JAX nodes run with PEX off (a port node
has no PEX channel) and their host verify path; the port nodes run their
verify engine on device="cpu" (the kernels' plain versions).

Checked, with tolerance 0: heights 1-3 commit with identical block hashes
on all four nodes; a tx sent to a port node is applied by the JAX apps and
the reverse; a late port node fast-syncs from the JAX nodes and then
follows the tip; a double-sign reaches every node's evidence pool and a
block; on `proxy_app = "staking"` a bond from a key outside the net and
an epoch's power shift give identical blocks, app hashes and sets.  Each wait runs under asyncio.wait_for with its own limit.
"""

import asyncio
import time

import torch

from tendermint_tpu.abci.types import RequestQuery as JRequestQuery
from tendermint_tpu.config import test_config as jtest_config
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.node import Node as JNode
from tendermint_tpu.types import GenesisDoc as JGenesisDoc
from tendermint_tpu.types import GenesisValidator as JGenesisValidator
from tendermint_tpu.types import MockPV as JMockPV
from tendermint_tpu.types.params import BlockParams as JBP
from tendermint_tpu.types.params import ConsensusParams as JCP
from tendermint_tpu_torch.abci.types import RequestQuery as PRequestQuery
from tendermint_tpu_torch.config import test_config as ptest_config
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey as PPrivKey
from tendermint_tpu_torch.node import Node as PNode
from tendermint_tpu_torch.types.genesis import GenesisDoc as PGenesisDoc
from tendermint_tpu_torch.types.genesis import GenesisValidator as PGenesisValidator
from tendermint_tpu_torch.types.params import BlockParams as PBP
from tendermint_tpu_torch.types.params import ConsensusParams as PCP
from tendermint_tpu_torch.types.priv_validator import MockPV as PMockPV

torch.set_num_threads(1)

CHAIN_ID = "mixed-net"
T0 = 1_700_000_000_000_000_000


def _seeds(n, tag):
    return sorted((bytes([i + 1]) * 16 + tag.encode().ljust(16, b"-") for i in range(n)),
                  key=lambda s: PPrivKey(s).pub_key().address())


def _genesis(seeds, app_state=None):
    """The same genesis in both packages (time_iota_ms 1, as make_net)."""
    jg = JGenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=T0, consensus_params=JCP(
        block=JBP(time_iota_ms=1)), validators=[
        JGenesisValidator(JPrivKey(s).pub_key().address(), JPrivKey(s).pub_key(), 10)
        for s in seeds])
    pg = PGenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=T0, consensus_params=PCP(
        block=PBP(time_iota_ms=1)), validators=[
        PGenesisValidator(PPrivKey(s).pub_key().address(), PPrivKey(s).pub_key(), 10)
        for s in seeds])
    jg.app_state = pg.app_state = app_state
    return jg, pg


def _node(kind, tmp_path, name, seed, jg, pg, fast_sync=False, app="kvstore"):
    test_config = jtest_config if kind == "jax" else ptest_config
    cfg = test_config(str(tmp_path / name))
    cfg.base.proxy_app = app
    cfg.rpc.laddr = ""
    cfg.base.db_backend = "memdb"
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.consensus.skip_timeout_commit = False
    cfg.consensus.timeout_commit = 0.1
    cfg.base.fast_sync = fast_sync
    if kind == "jax":
        return JNode(cfg, jg, priv_validator=JMockPV(JPrivKey(seed)), db_backend="memdb")
    cfg.tpu.enabled = True
    return PNode(cfg, pg, priv_validator=PMockPV(PPrivKey(seed)), db_backend="memdb",
                 device="cpu")


async def _dial(a, b):
    await a.switch.dial_peer(f"{b.node_key.id}@{b.switch.transport.listen_addr}")


async def _mesh(nodes):
    for i in range(len(nodes)):
        for j in range(i + 1, len(nodes)):
            await _dial(nodes[i], nodes[j])

    async def meshed():
        while not all(n.switch.num_peers() == len(nodes) - 1 for n in nodes):
            await asyncio.sleep(0.01)

    await asyncio.wait_for(meshed(), 10.0)


async def _make_net(tmp_path, kinds, name="mix", app="kvstore", app_state=None):
    seeds = _seeds(len(kinds), name)
    jg, pg = _genesis(seeds, app_state)
    nodes = [_node(k, tmp_path, f"{name}{i}", s, jg, pg, app=app) for i, (k, s) in
             enumerate(zip(kinds, seeds))]
    for n in nodes:
        await n.start()
    await _mesh(nodes)
    return nodes, seeds, jg, pg


async def _stop(nodes):
    for n in nodes:
        if n.is_running:
            await n.stop()
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)


async def _wait_height(nodes, h, timeout):
    async def reached():
        while not all(n.block_store.height() >= h for n in nodes):
            await asyncio.sleep(0.05)

    await asyncio.wait_for(reached(), timeout)


def _block_hash(n, h):
    return n.block_store.load_block(h).hash()


KINDS = ("jax", "port", "jax", "port")


async def test_mixed_net_commits_identical_blocks(tmp_path):
    nodes, *_ = await _make_net(tmp_path, KINDS)
    try:
        await _wait_height(nodes, 3, 40.0)
        for h in range(1, 4):
            assert len({_block_hash(n, h) for n in nodes}) == 1, f"height {h} diverged"
        app_hashes = {n.block_store.load_block(3).header.app_hash for n in nodes}
        assert len(app_hashes) == 1
        commit = nodes[1].block_store.load_block_commit(2)
        assert commit.size() == 4
        assert sum(1 for cs in commit.signatures if not cs.is_absent()) >= 3
        # the port's reactor took votes from JAX peers through its engine lane
        for n in nodes[1::2]:
            assert n.consensus_reactor.async_verifier is n.async_verifier
    finally:
        await _stop(nodes)


async def _applied(nodes, key, value, timeout):
    async def everywhere():
        while True:
            vals = []
            for n in nodes:
                req = (PRequestQuery if isinstance(n, PNode) else JRequestQuery)(data=key)
                vals.append((await n.proxy_app.query().query(req)).value)
            if all(v == value for v in vals):
                return
            await asyncio.sleep(0.05)

    await asyncio.wait_for(everywhere(), timeout)


async def test_mixed_net_tx_gossip_both_ways(tmp_path):
    nodes, *_ = await _make_net(tmp_path, KINDS, name="tx")
    try:
        await _wait_height(nodes, 1, 30.0)
        await nodes[1].mempool.check_tx(b"from-port=p")  # a port node
        await _applied(nodes, b"from-port", b"p", 30.0)
        await nodes[0].mempool.check_tx(b"from-jax=j")  # a JAX node
        await _applied(nodes, b"from-jax", b"j", 30.0)
    finally:
        await _stop(nodes)


async def test_late_port_node_fast_syncs_from_jax_nodes(tmp_path):
    """Three validators (two JAX, one port) hold 30 of 40 and commit; the
    fourth, a port node with fast sync on, joins late: it fast-syncs from
    its peers, switches to consensus and follows the tip."""
    seeds = _seeds(4, "late")
    jg, pg = _genesis(seeds)
    kinds = ("jax", "jax", "port")
    nodes = [_node(k, tmp_path, f"late{i}", s, jg, pg) for i, (k, s) in
             enumerate(zip(kinds, seeds[:3]))]
    late = _node("port", tmp_path, "late3", seeds[3], jg, pg, fast_sync=True)
    try:
        for n in nodes:
            await n.start()
        await _mesh(nodes)
        await _wait_height(nodes, 4, 40.0)
        await late.start()
        assert late.consensus_reactor.wait_sync
        for n in nodes:
            await _dial(late, n)
        await _wait_height([late], 3, 30.0)

        async def switched():
            while late.consensus_reactor.wait_sync or not late.consensus.is_running:
                await asyncio.sleep(0.05)

        await asyncio.wait_for(switched(), 30.0)
        assert late.blockchain_reactor.blocks_synced >= 1
        before = late.block_store.height()
        await _wait_height([late], before + 2, 30.0)
        for h in range(1, before + 3):
            assert _block_hash(late, h) == _block_hash(nodes[0], h)
    finally:
        await _stop(nodes + [late])


async def test_double_sign_evidence_reaches_every_pool_and_a_block(tmp_path):
    """A validator double-signs a prevote; the port node that sees both
    votes turns them into DuplicateVoteEvidence, the evidence reactors carry
    it to every node (JAX and port) and a block commits it."""
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.canonical import PREVOTE_TYPE
    from tendermint_tpu_torch.types.vote import Vote

    nodes, seeds, _, _ = await _make_net(tmp_path, KINDS, name="byz")
    try:
        await _wait_height(nodes, 2, 30.0)
        byz = PMockPV(PPrivKey(seeds[0]))
        target = nodes[1]  # a port node
        h = target.consensus.rs.height
        votes = []
        for fill in (b"\x0a", b"\x0b"):
            v = Vote(type=PREVOTE_TYPE, height=h, round=5,
                     block_id=BlockID(fill * 32, PartSetHeader(1, fill * 32)),
                     timestamp_ns=time.time_ns(), validator_address=byz.address(),
                     validator_index=0)
            byz.sign_vote(CHAIN_ID, v)
            votes.append(v)
        for v in votes:
            await target.consensus.add_vote_input(v, peer_id="byz-peer")

        async def committed_everywhere():
            while True:
                found = []
                for n in nodes:
                    blocks = [n.block_store.load_block(hh)
                              for hh in range(1, n.block_store.height() + 1)]
                    evs = [ev for b in blocks if b is not None for ev in b.evidence]
                    found.append(bool(evs) and all(n.evidence_pool.is_committed(ev)
                                                   for ev in evs))
                if all(found):
                    return
                await asyncio.sleep(0.05)

        await asyncio.wait_for(committed_everywhere(), 40.0)
        hashes = {ev.hash() for n in nodes for hh in range(1, n.block_store.height() + 1)
                  for ev in (n.block_store.load_block(hh).evidence or [])}
        assert len(hashes) == 1
    finally:
        await _stop(nodes)


STK_EPOCH = 4


async def test_mixed_net_on_the_staking_app_agrees_across_a_bond_and_an_epoch(tmp_path):
    """Two JAX and two port nodes on the staking app (epoch 4): a bond of
    15 from a key that runs no node enters through a port node's mempool;
    it joins at H+2, the next epoch permutes the five powers, and every
    node holds the same blocks, app hashes and sets throughout."""
    from tendermint_tpu_torch.apps.staking import make_bond_tx

    nodes, *_ = await _make_net(tmp_path, KINDS, name="stk", app="staking",
                                app_state={"staking": {"epoch_length": STK_EPOCH}})
    outsider = PPrivKey.from_secret(b"mixed-net-bond")
    try:
        await _wait_height(nodes, 2, 40.0)
        res = await nodes[1].mempool.check_tx(make_bond_tx(outsider, 15, 0))
        assert res.code == 0
        addr = outsider.pub_key().address()

        def joined():
            return nodes[0].state_store.load().validators.has_address(addr)

        async def until_joined():
            while not joined():
                await asyncio.sleep(0.05)

        await asyncio.wait_for(until_joined(), 40.0)
        top = nodes[0].block_store.height() + 2 * STK_EPOCH
        await _wait_height(nodes, top, 60.0)
        for h in range(1, top + 1):
            assert len({_block_hash(n, h) for n in nodes}) == 1, f"height {h} diverged"
            assert len({n.block_store.load_block(h).header.app_hash for n in nodes}) == 1
        sets = {h: nodes[1].state_store.load_validators(h) for h in range(1, top + 1)}
        for n in nodes:
            for h in (1, top):
                assert n.state_store.load_validators(h).hash() == sets[h].hash()
        shifted = [h for h in range(2, top + 1)
                   if sets[h].pubkeys_digest() == sets[h - 1].pubkeys_digest()
                   and sets[h].hash() != sets[h - 1].hash()]
        assert sets[top].size() == 5 and shifted, "no epoch shift seen"
        assert sorted(v.voting_power for v in sets[top].validators) == [10, 10, 10, 10, 15]
    finally:
        await _stop(nodes)
