"""The port's chaos engine (tendermint_tpu_torch/chaos: scenario.py,
link.py, checker.py, twin.py; p2p/fuzz.py and the Switch's link layer)
against the JAX package's, tolerance exact: the same inputs and seeds go
through both packages.

- Scenarios: the same text and seed give the same `timeline()`,
  `fingerprint()`, `duration()` and `twin_nodes()`, for both smoke rigs'
  scenarios (`chip_smoke.py` phase 17), the JAX docstring's full schedule
  with its `valset` clauses, and a mixed one; garbage is refused with the
  same ScenarioError text; the runner drives a recording rig with the same
  calls.  `valset join`/`leave`/`power`/`migrate ed25519` submit the same
  stake tx bytes, at the same nonces and through the same node, as the JAX
  InProcRig on recording nodes; `valset migrate N bls` submits the JAX
  rotate tx with the BLS candidate's proof of possession.
- Link policies: a seeded LinkPolicyTable gives the same drop, delay and
  throttle decisions over 10,000 sends and try_sends to four peers (the
  loop's sleep and clock injected, so no test sleeps), and the same
  `counters()` and `policies()`; PeerFuzz and the Switch's fuzz_config
  build the same wildcard table.
- The checker: the same seeded observation stream gives the same
  violations, summary and agreed heights; RecoveryTimer on an injected
  clock the same recovery ms.
- The twin: TwinSigner's conflicting vote is byte-identical (block id and
  signature) to the JAX one.
- In-process port Nodes (device="cpu", memdb, 127.0.0.1): on the staking
  app, `valset join 4 power=5` and `valset leave 4` change the set at
  H+2 with zero checker violations; a {0,1}|{2,3}
  partition stalls the net and heals within the bound; a twin's double
  sign is committed as evidence and reaches BeginBlock's
  byzantine_validators; the six `unsafe_chaos_*` routes answer as the JAX
  routes do, with chaos on and with it off, and stay behind `rpc.unsafe`.
- `check_ported` accepts `chaos.enabled` and `p2p.test_fuzz` (and
  `tpu.bls_jax_aggregation`, the batched BLS fold) and still refuses
  `tpu.mesh = "on"`.
- Phase 17 (a) of chip_smoke.py rehearsed on the CPU: four port nodes
  through the CLI in processes of their own, on the host path.
"""

import asyncio
import os
import random
import time
import types

import pytest

import tendermint_tpu.chaos.checker as jchecker
import tendermint_tpu.chaos.link as jlink
import tendermint_tpu.chaos.scenario as jscenario
import tendermint_tpu.chaos.twin as jtwin
import tendermint_tpu.p2p.fuzz as jfuzz
from tendermint_tpu.config import test_config as jtest_config
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.node import Node as JNode
from tendermint_tpu.rpc import jsonrpc as jjsonrpc
from tendermint_tpu.rpc.core import RPCCore as JRPCCore
from tendermint_tpu.types import GenesisDoc as JGenesisDoc
from tendermint_tpu.types import GenesisValidator as JGenesisValidator
from tendermint_tpu.types import MockPV as JMockPV
from tendermint_tpu.types.block import BlockID as JBlockID
from tendermint_tpu.types.block import PartSetHeader as JPartSetHeader
from tendermint_tpu.types.params import BlockParams as JBP
from tendermint_tpu.types.params import ConsensusParams as JCP
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu_torch import chaos as pchaos
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.abci.types import RequestQuery
from tendermint_tpu_torch.chaos import checker as pchecker
from tendermint_tpu_torch.chaos import link as plink
from tendermint_tpu_torch.chaos import scenario as pscenario
from tendermint_tpu_torch.chaos import twin as ptwin
from tendermint_tpu_torch.config import test_config as ptest_config
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey as PPrivKey
from tendermint_tpu_torch.p2p import fuzz as pfuzz
from tendermint_tpu_torch.rpc import jsonrpc as pjsonrpc
from tendermint_tpu_torch.rpc.core import RPCCore as PRPCCore
from tendermint_tpu_torch.types.block import BlockID as PBlockID
from tendermint_tpu_torch.types.block import PartSetHeader as PPartSetHeader
from tendermint_tpu_torch.types.genesis import GenesisDoc as PGenesisDoc
from tendermint_tpu_torch.types.genesis import GenesisValidator as PGenesisValidator
from tendermint_tpu_torch.types.params import BlockParams as PBP
from tendermint_tpu_torch.types.params import ConsensusParams as PCP
from tendermint_tpu_torch.types.priv_validator import MockPV as PMockPV
from tendermint_tpu_torch.types.vote import Vote as PVote

CHAIN_ID = "chaos-parity"
T0 = 1_700_000_000_000_000_000

# -- scenarios -----------------------------------------------------------------------

SCENARIOS = {
    # chip_smoke.py phase 17 (a), the JAX networks/local/chaos_smoke.py's
    "chaos_smoke": "twin 0; partition 0,1|2,3 @2~0.5; heal @8~0.5; kill 2 @11; restart 2 @13",
    # phase 17 (b), networks/local/disk_smoke.py's
    "disk_smoke": ("rot 3 blockstore h=3 @2; disk 2 enospc @8~0.5; disk 2 heal @16; "
                   "kill 2 @18; restart 2 @20"),
    # the JAX scenario module's docstring schedule, valset clauses included
    "docstring": """
        twin 0
        partition 0,1|2,3 @3~0.5
        heal @9~0.5
        kill 2 @12
        restart 2 @14
        link 0->3 drop=0.3 delay=0.02 @16
        skew 1 0.75 @18
        disk 2 enospc @20~0.5
        disk 2 heal @26
        rot 1 blockstore h=3 @22
        valset join 4 power=20 @24
        valset power 1=50 @28
        valset migrate 0 bls @30
        valset leave 2 @34
    """,
    "mixed": ("partition 0|1,2|3 @0.5~0.4  # three groups\n"
              "link 1->0 jitter=0.01 rate=5000 @1~1; disk 1 torn store=wal p=0.25 @2~2\n"
              "disk 0 fsync_lie store=spool @3; disk 0 heal store=spool @4; "
              "valset migrate 3 ed25519 @5~0.5; valset join 2 @6; skew 3 -1.5 @7~7"),
}


def _events(s):
    return [(e.t, e.action, e.args, e.spec) for e in s.timeline()]


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_timeline_and_fingerprint_equal_jax(name, seed):
    text = SCENARIOS[name]
    j = jscenario.Scenario.parse(text, seed=seed)
    p = pscenario.Scenario.parse(text, seed=seed)
    assert _events(p) == _events(j)
    assert p.fingerprint() == j.fingerprint()
    assert p.fingerprint() == pscenario.Scenario.parse(text, seed=seed).fingerprint()
    assert (p.duration(), p.twin_nodes()) == (j.duration(), j.twin_nodes())


BAD = ["explode 3 @1", "partition 0,1 @2", "link 0-3 drop=1 @1", "link 0->3 frob=1 @1",
       "kill @2", "disk 2 headcrash @1", "disk 2 enospc store=floppy @1", "disk 2 enospc q=1 @1",
       "rot 1 statestore h=3 @1", "rot 1 blockstore @1", "rot 1 blockstore h=x @1", "valset",
       "valset join 1 power=0 @1", "valset join 1 weight=3", "valset migrate 0 rsa @1",
       "valset swap 1 @1", "skew x 1 @1"]


@pytest.mark.parametrize("bad", BAD)
def test_scenario_garbage_is_refused_as_jax(bad):
    errs = []
    for mod in (jscenario, pscenario):
        with pytest.raises(mod.ScenarioError) as ei:
            mod.Scenario.parse(bad)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


class _RecordingRig:
    node_count = 4

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        async def call(*args, **kw):
            pol = args[-1] if name == "set_link" else None
            if pol is not None:
                args = args[:-1] + (pol.to_dict(),)
            self.calls.append((name, args, kw))
        return call


async def test_runner_drives_the_rig_with_the_jax_calls(monkeypatch):
    text = ("partition 0|1,2 @0; link 0->3 drop=0.5 delay=0.25 @0; heal @0; kill 1 @0; "
            "restart 1 @0; skew 0 1.5 @0; disk 2 eio store=wal p=0.5 @0; "
            "rot 1 blockstore h=2 part=1 @0; disk 2 heal @0")
    calls = []
    for mod in (jscenario, pscenario):
        rig = _RecordingRig()
        await mod.ScenarioRunner(mod.Scenario.parse(text, seed=3), rig).run()
        calls.append(rig.calls)
    assert calls[0] == calls[1] and len(calls[1]) == 12


@pytest.mark.parametrize("clause, item", [("valset migrate 0 bls", "1.9")])
async def test_valset_clauses_raise_naming_the_staking_app(clause, item):
    """`valset migrate N bls` (ROADMAP 1.9, aggregate commits included) is
    lifted: node 0's RotatingPV holds an ed25519 owner key and a BLS
    candidate, and the clause submits the JAX rotate tx, the candidate's
    proof of possession in it, at the same nonce through the same node;
    the port's scenario module names ROADMAP `item` nowhere any more."""
    import inspect

    assert f"ROADMAP {item}" not in inspect.getsource(pscenario)
    seen = {}
    for pkg, mod in (("jax", jscenario), ("port", pscenario)):
        nodes = _stake_rig_nodes(pkg, "rotating-bls", False)
        await mod.ScenarioRunner(mod.Scenario.parse(clause), mod.InProcRig(nodes)).run()
        seen[pkg] = [(n.sent, n.queries) for n in nodes]
    assert seen["port"] == seen["jax"]
    (tx,), _ = seen["port"][0]
    import base64

    from tendermint_tpu_torch.crypto.bls import BlsPrivKey

    pop = base64.b64encode(BlsPrivKey.from_secret(b"valset-bls").pop())
    assert b"stake:rotate:bls12381:" in tx and pop in tx


class _StakeRecNode:
    """A running node as InProcRig.valset sees it: a privval, a query
    connection answering `nonce`, and a mempool that records each tx."""

    def __init__(self, pv, nonce, running=True):
        self.priv_validator, self.nonce, self.is_running = pv, nonce, running
        self.sent, self.queries = [], []
        self.proxy_app = types.SimpleNamespace(query=lambda: self)
        self.mempool = types.SimpleNamespace(check_tx=self._check_tx)

    async def query(self, req):
        self.queries.append((req.path, req.data))
        return types.SimpleNamespace(value=str(self.nonce).encode())

    async def _check_tx(self, tx):
        self.sent.append(tx)
        return types.SimpleNamespace(code=0, log="")


def _stake_rig_nodes(pkg, pv_kind, down):
    """Two recording nodes of one package: node 0's privval is a MockPV, a
    RotatingPV of two ed25519 keys or a TwinSigner; node 1's a MockPV."""
    if pkg == "jax":
        from tendermint_tpu.crypto.bls import BlsPrivKey
        from tendermint_tpu.types import RotatingPV
        Key, MockPV, Twin = JPrivKey, JMockPV, jtwin.TwinSigner
    else:
        from tendermint_tpu_torch.crypto.bls import BlsPrivKey
        from tendermint_tpu_torch.types.priv_validator import RotatingPV
        Key, MockPV, Twin = PPrivKey, PMockPV, ptwin.TwinSigner
    k0, k0b, k1 = (Key.from_secret(b"valset-%d" % i) for i in range(3))
    pv0 = {"mock": lambda: MockPV(k0), "rotating": lambda: RotatingPV(MockPV(k0), MockPV(k0b)),
           "rotating-bls": lambda: RotatingPV(
               MockPV(k0), MockPV(BlsPrivKey.from_secret(b"valset-bls"))),
           "twin": lambda: Twin(MockPV(k0))}[pv_kind]()
    return [_StakeRecNode(pv0, 3, running=not down), _StakeRecNode(MockPV(k1), 7)]


@pytest.mark.parametrize("clause, pv_kind, down", [
    ("valset join 0 power=5", "mock", False), ("valset join 1 power=20", "mock", False),
    ("valset leave 0", "twin", False), ("valset leave 0", "mock", True),
    ("valset power 0=50", "rotating", False), ("valset power 1=1", "mock", False),
    ("valset migrate 0 ed25519", "rotating", False), ("valset migrate 0 ed25519", "mock", True)])
async def test_valset_clauses_make_the_jax_stake_txs(clause, pv_kind, down):
    """Each clause signs its stake tx with the node's ed25519 owner key
    (unwrapped from a RotatingPV or TwinSigner), at the nonce the submitting
    node's app answers, through the node itself or, when it is down, the
    first running one; `migrate ed25519` picks the ed25519 key in use."""
    seen = {}
    for pkg, mod in (("jax", jscenario), ("port", pscenario)):
        nodes = _stake_rig_nodes(pkg, pv_kind, down)
        await mod.ScenarioRunner(mod.Scenario.parse(clause), mod.InProcRig(nodes)).run()
        seen[pkg] = [(n.sent, n.queries) for n in nodes]
    assert seen["port"] == seen["jax"]
    assert sum(len(sent) for sent, _ in seen["port"]) == 1


# -- link policies -------------------------------------------------------------------


class _FakePeer:
    def __init__(self, pid):
        self.id = pid
        self.is_running = True
        self.sent = []
        self.spawned = []

    async def send(self, chan_id, msg):
        self.sent.append((chan_id, len(msg)))
        return True

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, len(msg)))
        return True

    def spawn(self, coro, name=""):
        self.spawned.append(name)
        coro.close()


class _Clock:
    """The loop's clock and sleep as link.py reads them, injected."""

    def __init__(self):
        self.now = 100.0
        self.slept = []

    def time(self):
        return self.now

    def get_event_loop(self):
        return self

    async def sleep(self, s):
        self.slept.append(round(s, 12))
        self.now += s


async def _drive_links(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "asyncio", clock)
    table = mod.LinkPolicyTable(seed=2024)
    peers = [_FakePeer(f"peer-{i}") for i in range(4)]
    for p in peers:
        table.install(p)
    rng = random.Random(5)
    out = []
    for k in range(10_000):
        if k % 2500 == 0:
            table.heal()
            table.set_policy("peer-0", mod.LinkPolicy(drop=0.3, jitter=0.02))
            table.set_policy("peer-1", mod.LinkPolicy(delay=0.01))
            table.set_policy("peer-2", mod.LinkPolicy(rate_bytes_per_sec=50_000.0, drop=0.05))
            table.set_policy("*", mod.LinkPolicy(drop=0.1, delay=0.001))
        if k == 6000:
            table.set_policy("peer-3", mod.PARTITIONED)
        peer = peers[rng.randrange(4)]
        msg = b"x" * rng.randrange(1, 4000)
        clock.now += rng.random() * 0.01
        if k % 5 == 0:
            out.append((peer.id, "try", peer.try_send(0x22, msg)))
        else:
            out.append((peer.id, "send", await peer.send(0x22, msg)))
    return out, clock.slept, table.counters(), table.policies(), [
        (p.sent, p.spawned) for p in peers]


async def test_link_table_decisions_over_10000_sends_equal_jax(monkeypatch):
    j = await _drive_links(jlink, monkeypatch)
    p = await _drive_links(plink, monkeypatch)
    assert p == j
    decisions, slept, counters = p[0], p[1], p[2]
    assert 0 < counters["dropped_sends"] < 10_000 and counters["delayed_sends"] > 1000
    assert counters["throttled_bytes"] > 0 and len(slept) > 1000
    assert sum(1 for d in decisions if d[2] is False) == counters["dropped_sends"]


def test_peer_fuzz_and_the_switch_fuzz_config_build_the_jax_table():
    from tendermint_tpu.p2p.switch import Switch as JSwitch
    from tendermint_tpu_torch.p2p.switch import Switch as PSwitch

    cfg = {"prob_drop_rw": 0.2, "max_delay": 0.05, "seed": 9}
    for j, p in ((jfuzz.PeerFuzz(0.2, 0.05, seed=9).table, pfuzz.PeerFuzz(0.2, 0.05, seed=9).table),
                 (jfuzz.table_from_fuzz_config(cfg), pfuzz.table_from_fuzz_config(cfg))):
        assert p.policies() == j.policies() == {"*": {"drop": 0.2, "delay": 0.0, "jitter": 0.05,
                                                      "rate_bytes_per_sec": 0.0}}
        assert [p.rng.random() for _ in range(5)] == [j.rng.random() for _ in range(5)]
    tables = [S(types.SimpleNamespace(), fuzz_config=cfg).link_policies for S in (JSwitch, PSwitch)]
    assert tables[1].policies() == tables[0].policies()
    table = plink.LinkPolicyTable(seed=1)
    assert PSwitch(types.SimpleNamespace(), link_policies=table).link_policies is table
    assert PSwitch(types.SimpleNamespace()).link_policies is None



@pytest.mark.parametrize("policy", [{"delay": 2.0, "jitter": 3.0}, {"rate_bytes_per_sec": 40.0}],
                         ids=["delay", "throttle"])
async def test_slow_pex_links_make_no_request_flood(policy, monkeypatch):
    """ROADMAP 3.9 under the link layer: with a delayed or throttled link
    both ways (the loop's clock and sleep injected), the port's PEX sender
    spaces each request from the reply it read, so the receiver reads every
    request at least REQUEST_INTERVAL after the last and stops no peer for
    a flood over six rounds."""
    import tendermint_tpu_torch.p2p.pex.addrbook as paddrbook
    import tendermint_tpu_torch.p2p.pex.pex_reactor as ppexmod
    from test_torch_pex import FakePeer, FakeSwitch, mk_addr

    clock = _Clock()
    monkeypatch.setattr(plink, "asyncio", clock)
    sender, receiver = (ppexmod.PEXReactor(paddrbook.AddrBook(strict=False),
                                           now_fn=clock.time) for _ in range(2))
    for i in range(40, 50):
        receiver.book.add_address(mk_addr(i), src="s")
    class Peer(FakePeer):
        is_running = True

        def try_send(self, chan, data):
            raise AssertionError("PEX sends with send")

    to_r, to_s = Peer("b" * 40, outbound=True), Peer("a" * 40)
    for peer in (to_r, to_s):
        table = plink.LinkPolicyTable(seed=3)
        table.install(peer)
        table.set_policy(peer.id, plink.LinkPolicy(**policy))
    sender.switch, receiver.switch = FakeSwitch([to_r]), FakeSwitch([to_s])
    reads = []
    for _ in range(6):
        await sender._request_addrs(to_r)
        while to_r.sent:
            reads.append(clock.now)
            await receiver.receive(0x00, to_s, to_r.sent.pop(0)[1])
        while to_s.sent:
            await sender.receive(0x00, to_r, to_s.sent.pop(0)[1])
        clock.now += 16.0  # the sender's ensure-peers ticks
    assert receiver.switch.stopped == [] and len(reads) == 6
    assert all(b - a >= ppexmod.REQUEST_INTERVAL for a, b in zip(reads, reads[1:]))
    assert to_s.link.delayed_sends == 6 and clock.slept  # every reply waited

# -- the checker ---------------------------------------------------------------------


def _observations(seed, n=2000):
    rng = random.Random(seed)
    hashes = {h: bytes([h % 256]) * 32 for h in range(1, 200)}
    out = []
    for _ in range(n):
        node, h = rng.randrange(4), rng.randrange(1, 200)
        r = rng.random()
        if r < 0.4:
            out.append(("observe_height", node, rng.choice([h, None, -1, h - 5])))
        elif r < 0.8:
            out.append(("observe_block_hash", node, h,
                        hashes[h] if rng.random() < 0.98 else b"\xee" * 32))
        elif r < 0.95:
            claimed = hashes[h]
            out.append(("observe_served_block", node, h, claimed,
                        claimed if rng.random() < 0.95 else b"\x01" * 32))
        else:
            out.append(("note_restart", node))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_checker_verdicts_equal_jax(seed):
    results = []
    for mod in (jchecker, pchecker):
        c = mod.InvariantChecker(4, liveness_exempt=[0])
        for name, *args in _observations(seed):
            getattr(c, name)(*args)
        results.append((c.violations, c.summary(), c.agreed_heights(), c.ok(), c.last_height))
        if not c.ok():
            with pytest.raises(mod.InvariantViolation):
                c.raise_if_violated()
    assert results[1] == results[0]
    assert results[1][0]  # the stream does violate


def test_recovery_timer_equal_jax():
    results = []
    for mod in (jchecker, pchecker):
        now = [100.0]
        rt = mod.RecoveryTimer(now_fn=lambda: now[0])
        rt.mark("heal", 7)
        rt.mark("restart", 9)
        for h, t in ((7, 100.5), (None, 101.0), (8, 101.5), (-1, 102.0), (10, 103.25)):
            now[0] = t
            rt.observe(h)
        rt.mark("never", 50)
        results.append((rt.recovery_ms, rt.unrecovered()))
    assert results[1] == results[0] == ({"heal": 1500.0, "restart": 3250.0}, ["never"])


# -- the twin ------------------------------------------------------------------------


@pytest.mark.parametrize("zero", [False, True], ids=["block", "nil-hash"])
def test_twin_conflicting_vote_equals_jax(zero):
    seed = b"twin-seed".ljust(32, b"\0")
    out = []
    for Vote, BlockID, PSH, PrivKey, MockPV, twin in (
            (JVote, JBlockID, JPartSetHeader, JPrivKey, JMockPV, jtwin),
            (PVote, PBlockID, PPartSetHeader, PPrivKey, PMockPV, ptwin)):
        signer = twin.TwinSigner(MockPV(PrivKey(seed)))
        bid = BlockID(b"" if zero else bytes(range(32)), PSH(3, bytes(range(32, 64))))
        vote = Vote(type=1, height=5, round=2, block_id=bid, timestamp_ns=T0 + 7,
                    validator_address=signer.address(), validator_index=1)
        signer.sign_vote(CHAIN_ID, vote)
        conflict = signer.conflicting_vote(CHAIN_ID, vote)
        out.append((vote.signature, conflict.block_id.hash, conflict.block_id.parts_header.total,
                    conflict.block_id.parts_header.hash, conflict.signature, signer.equivocations,
                    signer.sign_challenge(b"n" * 32)))
    assert out[1] == out[0]


def test_twin_needs_a_local_key():
    with pytest.raises(TypeError, match="needs a local key"):
        ptwin.TwinSigner(object())


# -- in-process port nodes -----------------------------------------------------------


def _seeds(n, tag):
    return sorted((bytes([i + 1]) * 16 + tag.encode().ljust(16, b"-") for i in range(n)),
                  key=lambda s: PPrivKey(s).pub_key().address())


def _pgenesis(seeds):
    return PGenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=T0,
                       consensus_params=PCP(block=PBP(time_iota_ms=1)),
                       validators=[PGenesisValidator(PPrivKey(s).pub_key().address(),
                                                     PPrivKey(s).pub_key(), 10) for s in seeds])


def _jgenesis(seeds):
    return JGenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=T0,
                       consensus_params=JCP(block=JBP(time_iota_ms=1)),
                       validators=[JGenesisValidator(JPrivKey(s).pub_key().address(),
                                                     JPrivKey(s).pub_key(), 10) for s in seeds])


def _cfg(test_config, home, twin=False, enabled=True, app="kvstore"):
    cfg = test_config(home)
    cfg.base.proxy_app = app
    cfg.rpc.laddr = ""
    cfg.base.db_backend = "memdb"
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.consensus.skip_timeout_commit = False
    cfg.consensus.timeout_commit = 0.1
    cfg.chaos.enabled = enabled
    cfg.chaos.seed = 1234
    cfg.chaos.twin = twin
    return cfg


async def _chaos_net(tmp_path, n, name, twin_idx=None, validators=None, app="kvstore"):
    seeds = _seeds(n, name)
    gen = _pgenesis(seeds[:validators or n])
    if app == "staking":
        gen.app_state = {"staking": {"epoch_length": 0}}
    nodes = [pnode.Node(_cfg(ptest_config, str(tmp_path / f"{name}{i}"), twin=twin_idx == i,
                             app=app),
                        gen, priv_validator=PMockPV(PPrivKey(s)), db_backend="memdb",
                        device="cpu") for i, s in enumerate(seeds)]
    for node in nodes:
        await node.start()
    for i in range(n):
        for j in range(i + 1, n):
            b = nodes[j]
            await nodes[i].switch.dial_peer(f"{b.node_key.id}@{b.switch.transport.listen_addr}")

    async def meshed():
        while not all(node.switch.num_peers() == n - 1 for node in nodes):
            await asyncio.sleep(0.01)

    await asyncio.wait_for(meshed(), 10.0)
    return nodes


async def _stop(nodes):
    for node in nodes:
        if node.is_running:
            await node.stop()


async def _wait_heights(nodes, h, timeout=30.0):
    async def reached():
        while not all(n.block_store.height() >= h for n in nodes):
            await asyncio.sleep(0.05)

    await asyncio.wait_for(reached(), timeout)


def _stake_tx_height(node, owner_pub: bytes, verb: bytes) -> int:
    """The height of the block holding `owner_pub`'s stake tx with `verb`."""
    from tendermint_tpu_torch.mempool import parse_signed_tx

    for h in range(1, node.block_store.height() + 1):
        for tx in node.block_store.load_block(h).txs:
            parsed = parse_signed_tx(tx)
            if parsed and parsed[0] == owner_pub and parsed[3].startswith(b"stake:" + verb):
                return h
    raise AssertionError(f"no stake:{verb.decode()} tx of the node in a block")


async def test_valset_join_and_leave_change_the_set_at_h_plus_2(tmp_path):
    """Four port validators and a follower (node 4) on the staking app: the
    DSL's `valset join 4 power=5` bonds node 4 in and `valset leave 4` takes
    it out, each through its own mempool, and each takes effect exactly at
    H+2 of the block H holding its tx; the checker sees no violation."""
    nodes = await _chaos_net(tmp_path, 5, "stk", validators=4, app="staking")
    rig = pchaos.InProcRig(nodes)
    checker = pchaos.InvariantChecker(5)
    pub4 = nodes[4].priv_validator.get_pub_key()
    addr4 = pub4.address()

    async def until(cond, what):
        deadline = time.monotonic() + 30.0
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out waiting for {what}")
            for i, n in enumerate(nodes):
                checker.observe_node(i, n)
            await asyncio.sleep(0.05)

    try:
        await _wait_heights(nodes, 2)
        for clause, verb, member in (("valset join 4 power=5", b"bond", True),
                                     ("valset leave 4", b"edit", False)):
            await pchaos.ScenarioRunner(pchaos.Scenario.parse(clause), rig).run()
            await until(lambda: nodes[0].state_store.load().validators.has_address(addr4) == member,
                        clause)
            h = _stake_tx_height(nodes[0], pub4.bytes(), verb)
            await _wait_heights(nodes, h + 2)
            sets = [nodes[0].state_store.load_validators(x) for x in (h + 1, h + 2)]
            assert [s.has_address(addr4) for s in sets] == [not member, member], clause
            if member:
                assert sets[1].get_by_address(addr4)[1].voting_power == 5
                assert sets[1].size() == 5
        for i, n in enumerate(nodes):
            checker.observe_node(i, n)
        checker.raise_if_violated()
        updates = [e for e in nodes[0].flight_recorder.events() if e["kind"] == "valset.update"]
        assert [e["new_size"] for e in updates] == [5, 4]
    finally:
        await _stop(nodes)


async def test_partition_stalls_then_heals_within_bound(tmp_path):
    """JAX TestPartitionHealLiveness on port nodes: during a {0,1}|{2,3}
    split neither side has +2/3, so commits stop; after the heal they
    resume within 20 s, and every height agrees throughout."""
    nodes = await _chaos_net(tmp_path, 4, "part")
    checker = pchaos.InvariantChecker(4)
    rig = pchaos.InProcRig(nodes)
    try:
        assert all(isinstance(n.switch.link_policies, plink.LinkPolicyTable) for n in nodes)
        await _wait_heights(nodes, 2)
        await pchaos.ScenarioRunner(pchaos.Scenario.parse("partition 0,1|2,3 @0"), rig).run()
        await asyncio.sleep(1.0)  # drain in-flight gossip
        stall_h = max(n.block_store.height() for n in nodes)
        await asyncio.sleep(1.5)
        assert max(n.block_store.height() for n in nodes) <= stall_h + 1
        assert sum(n.switch.link_policies.counters()["dropped_sends"] for n in nodes) > 0
        for i, n in enumerate(nodes):
            checker.observe_node(i, n)
        timer = pchaos.RecoveryTimer()
        baseline = min(n.block_store.height() for n in nodes)
        timer.mark("heal", baseline)
        await rig.heal()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            h = min(n.block_store.height() for n in nodes)
            timer.observe(h)
            if "heal" in timer.recovery_ms and h >= baseline + 2:
                break
            await asyncio.sleep(0.1)
        assert timer.recovery_ms["heal"] < 20_000
        for i, n in enumerate(nodes):
            checker.observe_node(i, n)
        checker.raise_if_violated()
        assert len(checker.agreed_heights()) >= 2
    finally:
        await _stop(nodes)


async def test_twin_double_sign_reaches_byzantine_validators(tmp_path):
    """JAX TestTwinAccountability on port nodes: twin node 0 equivocates
    from genesis; the evidence is committed into a block and BeginBlock
    delivers it (the kvstore app's `__byzantine__` key)."""
    nodes = await _chaos_net(tmp_path, 4, "twin", twin_idx=0)
    twin_addr = nodes[0].priv_validator.get_pub_key().address()
    assert isinstance(nodes[0].priv_validator, ptwin.TwinSigner)
    checker = pchaos.InvariantChecker(4, liveness_exempt=[0])
    try:
        async def committed():
            while True:
                for n in nodes[1:]:
                    found = pchecker.scan_committed_evidence(n.block_store)
                    if found:
                        return n, found
                await asyncio.sleep(0.2)

        node, found = await asyncio.wait_for(committed(), 90.0)
        assert found[0][1].address() == twin_addr

        async def app_recorded():
            while True:
                for n in nodes[1:]:
                    res = await n.proxy_app.query().query(RequestQuery(data=b"__byzantine__"))
                    if res.value and twin_addr.hex().encode() in res.value:
                        return
                await asyncio.sleep(0.2)

        await asyncio.wait_for(app_recorded(), 30.0)
        kinds = {e["kind"] for e in node.flight_recorder.events()}
        assert "evidence.add" in kinds and "evidence.commit" in kinds
        assert "chaos.twin_vote" in {e["kind"] for e in nodes[0].flight_recorder.events()}
        assert nodes[0].priv_validator.equivocations >= 1
        for i, n in enumerate(nodes):
            checker.observe_node(i, n)
        checker.raise_if_violated()
    finally:
        await _stop(nodes)


def _route_calls():
    return [
        ("unsafe_chaos_status", {}),
        ("unsafe_chaos_link", {"peer_id": "*", "drop": 1.0}),
        ("unsafe_chaos_link", {"peer_id": "ab" * 20, "delay": 0.5, "jitter": 0.1, "rate": 100.0}),
        ("unsafe_chaos_status", {}),
        ("unsafe_chaos_heal", {}),
        ("unsafe_chaos_clock_skew", {"skew": 2.5}),
        ("unsafe_chaos_clock_skew", {"skew": -1.0}),
        ("unsafe_chaos_disk", {"kind": "enospc", "store": "mempool-wal", "p": 0.5}),
        ("unsafe_chaos_disk", {"kind": "fsync_lie", "store": "spool"}),
        ("unsafe_chaos_disk", {"kind": "eio", "store": "floppy"}),
        ("unsafe_chaos_disk", {"kind": "headcrash"}),
        ("unsafe_chaos_disk", {"kind": "heal", "store": "spool"}),
        ("unsafe_chaos_disk", {"kind": "heal"}),
        ("unsafe_chaos_rot", {"height": 999}),
        ("unsafe_chaos_rot", {"height": 1, "store": "state"}),
        ("unsafe_chaos_status", {}),
    ]


async def _answers(core, jsonrpc):
    out = []
    for method, params in _route_calls():
        try:
            out.append(("ok", jsonrpc.to_jsonable(await core.call(method, params))))
        except jsonrpc.RPCError as e:
            out.append(("err", e.code, e.message, e.data))
    return out


async def test_chaos_routes_answer_as_jax_with_chaos_on_and_off(tmp_path):
    """One solo validator in each package, p2p on, chaos on: every chaos
    route gives the JAX answer; the rot of a stored height flips the same
    key; behind `rpc.unsafe = false` none exists; with chaos off each
    gives the JAX error."""
    seeds = _seeds(1, "rpc")
    jnode = JNode(_cfg(jtest_config, str(tmp_path / "j")), _jgenesis(seeds),
                  priv_validator=JMockPV(JPrivKey(seeds[0])), db_backend="memdb")
    pn = pnode.Node(_cfg(ptest_config, str(tmp_path / "p")), _pgenesis(seeds),
                    priv_validator=PMockPV(PPrivKey(seeds[0])), db_backend="memdb", device="cpu")
    await jnode.start()
    await pn.start()
    try:
        await _wait_heights([jnode, pn], 2)
        cores = [(JRPCCore(jnode, unsafe=True), jjsonrpc), (PRPCCore(pn, unsafe=True), pjsonrpc)]
        j, p = [await _answers(core, mod) for core, mod in cores]
        assert p == j
        assert p[1][1]["policies"]["*"]["drop"] == 1.0 and p[5][1] == {"skew": 2.5}
        assert pn.consensus.clock.skew_s == -1.0 and pn.flight_recorder._wall_ns_fn is not None
        rots = [(await core.call("unsafe_chaos_rot", {"height": 1}))["rotted"]["key"]
                for core, _ in cores]
        assert rots == ["P:1:0", "P:1:0"]
        scans = [await core.call("unsafe_store_integrity_scan", {}) for core, _ in cores]
        assert [sorted(r) for r in scans] == [sorted(scans[0])] * 2
        assert [(r["corrupt"], r["quarantined"]) for r in scans] == [([1], [1])] * 2
        assert jnode.block_store.load_block(1) is None and pn.block_store.load_block(1) is None
        for node, core in ((jnode, JRPCCore), (pn, PRPCCore)):
            with pytest.raises((jjsonrpc.RPCError, pjsonrpc.RPCError)):
                await core(node, unsafe=False).call("unsafe_chaos_status")
        jnode.config.chaos.enabled = pn.config.chaos.enabled = False
        j, p = [await _answers(core, mod) for core, mod in cores]
        assert p == j and {a[2] for a in p} == {"chaos routes require [chaos] enabled"}
    finally:
        await pn.stop()
        await jnode.stop()


async def test_chaos_off_leaves_every_store_unwrapped(tmp_path):
    seeds = _seeds(1, "off")
    cfg = _cfg(ptest_config, str(tmp_path / "off"), enabled=False)
    cfg.base.db_backend = "sqlite"
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.instrumentation.flight_spool = True
    n = pnode.Node(cfg, _pgenesis(seeds), priv_validator=PMockPV(PPrivKey(seeds[0])),
                   device="cpu")
    await n.start()
    try:
        await _wait_heights([n], 1)
        assert n.disk_faults is None and n.switch.link_policies is None
        assert n.chaos_clock is None and isinstance(n.priv_validator, PMockPV)
        wrapped = (n.block_store.db, n.state_db, n.consensus.wal.group, n.mempool._wal,
                   n.flight_spool._group)
        assert not any(type(x).__name__.startswith("Faulty") for x in wrapped)
    finally:
        await n.stop()


# -- check_ported --------------------------------------------------------------------

PORTED = {"chaos": ("chaos", "enabled", True, None), "test_fuzz": ("p2p", "test_fuzz", True, None),
          "twin": ("chaos", "twin", True, None), "mesh_on": ("tpu", "mesh", "on", None),
          "bls_jax_aggregation": ("tpu", "bls_jax_aggregation", True, None)}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_check_ported_lifts_the_chaos_settings_only(case, tmp_path):
    section, field, value, item = PORTED[case]
    cfg = ptest_config(str(tmp_path))
    cfg.chaos.enabled = case == "twin"
    setattr(getattr(cfg, section), field, value)
    if item is None:
        pnode.check_ported(cfg)
    else:
        with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {item}\)"):
            pnode.check_ported(cfg)


# -- phase 17 (a) rehearsed ----------------------------------------------------------

CPU_NODE = """
import os
import sys
os.nice(5)  # a rehearsal's four busy nodes yield to the tests running beside them
import tendermint_tpu_torch.node as n
_device = n.engine_device
n.engine_device = lambda config, device=None: _device(config, "cpu")
from tendermint_tpu_torch.cli import main
sys.exit(main(["--home", sys.argv[1], "node"]))
"""


def chaos_phase_rehearsal(monkeypatch, part):
    """Phase 17's `part` on the CPU: its nodes through the CLI in their own
    processes with the engine on device="cpu" (the CLI's `node` wants the
    card) and `min_device_batch` above every batch, so each verifies on the
    host path; every check of the phase but the card's launches runs."""
    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ch_node_argv", lambda home: ["-c", CPU_NODE, home])
    monkeypatch.setattr(cs, "CH_MIN_DEVICE_BATCH", 1 << 16)
    return cs.phase_chaos("cpu", torch.device("cpu"), parts=part)


def test_phase17a_chaos_rig_on_cpu(monkeypatch):
    out = chaos_phase_rehearsal(monkeypatch, "a")["a"]
    assert out["fingerprint"] == pscenario.Scenario.parse(SCENARIOS["chaos_smoke"],
                                                          seed=7).fingerprint()
    assert out["violations"] == [] and out["evidence_height"] is not None
    assert out["byzantine_validators_delivered"] and out["trace_clamps"] >= 1
    assert 0 <= out["chaos_partition_recovery_ms"] < 30_000
    assert 0 <= out["restart_recovery_ms"] < 30_000
    assert out["health_detect_latency_ms"] > 0
    assert out["launches"] == [0, 0, 0, 0]  # the host path: no plain kernel ran
