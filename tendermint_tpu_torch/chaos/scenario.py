"""Declarative, seeded fault timelines and their executor (the port's copy
of tendermint_tpu/chaos/scenario.py).

A scenario is a tiny schedule DSL — one clause per fault, an `@time`
anchor, optional seeded jitter — compiled once into a RESOLVED timeline
(plain FaultEvents with concrete times).  The same scenario text + seed
always resolves to the same timeline (`fingerprint()` proves it), which is
what makes a chaos run replayable: a failure found at seed 7 is re-staged
with seed 7, byte-identical fault schedule.

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

Grammar: clauses separated by `;` or newlines, `#` comments.  `@T`
anchors the clause at T seconds from scenario start; `@T~J` jitters it
uniformly in [T-J, T+J] using the scenario seed (resolution happens in
clause order, so inserting a clause changes later draws — by design: the
seed fingerprints the WHOLE schedule).  Node references are integer
indices into the rig's node list.

Actions:
    twin N                      informational marker: node N is configured
                                as a double-signer from genesis (the twin
                                is installed by config, not at runtime)
    partition G1|G2[|G3...]     full bidirectional partition between the
                                groups (comma-separated indices)
    heal                        clear EVERY link policy on every node
    kill N / restart N          crash-stop and bring back node N
    link A->B k=v...            directional degraded link (drop= delay=
                                jitter= rate=)
    skew N S                    set node N's consensus wall-clock skew to
                                S seconds
    disk N KIND [store=S] [p=P] disk fault on node N: KIND in enospc|eio|
                                eio_fsync|torn|fsync_lie|bitrot (store
                                default "*" = every store, p default 1.0),
                                or KIND=heal to clear (optionally one store)
    rot N STORE h=H [part=I]    persistent seeded bit-rot: flip one byte in
                                node N's stored block part (height H); the
                                integrity scan must detect + quarantine it
    valset join N [power=P]     node N bonds into the validator set (stake
                                tx signed with its privval key; default
                                power 10)
    valset leave N              node N unbonds out of the set entirely
    valset power N=P            set node N's voting power to P outright
    valset migrate N SCHEME     rotate node N's consensus key live to
                                SCHEME in (bls|bls12381|ed25519) — the
                                node must hold the target key already
                                (RotatingPV candidate)

The valset clauses are faults in the same sense as partitions: they
mutate the validator set THROUGH the staking app's tx path (bond/edit/
rotate), so every assumption downstream — verify-table identity, BLS
aggregation uniformity, lite-client bisection — gets exercised exactly
the way a production set change would exercise it.  A `bls` migration
carries the new key's proof of possession in its rotate tx; once every
member has migrated, the set is uniformly BLS12-381 and its commits fold
into aggregate commits.

The executor (`ScenarioRunner`) drives any object satisfying the Rig
surface; `InProcRig` adapts a list of in-process Nodes (the test path),
and `chip_smoke.py` phase 17 implements the same actions over the
unsafe RPC routes + OS signals for the multi-process rig.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..libs.log import get_logger
from .link import PARTITIONED, LinkPolicy, degraded


@dataclass(frozen=True)
class FaultEvent:
    t: float  # seconds from scenario start (jitter already resolved)
    action: str
    args: dict = field(default_factory=dict)
    spec: str = ""  # the original clause, for logs and fingerprints

    def describe(self) -> str:
        return f"@{self.t:.3f}s {self.action} {self.args}"


class ScenarioError(ValueError):
    pass


def _parse_time(tok: str, rng: random.Random) -> float:
    """`@T` or `@T~J` -> resolved seconds."""
    body = tok[1:]
    if "~" in body:
        base_s, jit_s = body.split("~", 1)
        base, jit = float(base_s), float(jit_s)
        return max(0.0, base + rng.uniform(-jit, jit))
    return float(body)


def _parse_group(tok: str) -> List[int]:
    return [int(x) for x in tok.split(",") if x != ""]


_LINK_KEYS = {"drop", "delay", "jitter", "rate"}


class Scenario:
    """Parsed scenario: clauses + seed, resolved once into a timeline."""

    def __init__(self, events: List[FaultEvent], seed: int = 0, text: str = ""):
        self.seed = seed
        self.text = text
        self._timeline = sorted(events, key=lambda e: (e.t, e.spec))

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "Scenario":
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        clauses = [
            c.strip()
            for line in text.splitlines()
            for c in line.split("#", 1)[0].split(";")
        ]
        for clause in clauses:
            if not clause:
                continue
            toks = clause.split()
            t = 0.0
            if toks[-1].startswith("@"):
                t = _parse_time(toks.pop(), rng)
            action, args = toks[0], toks[1:]
            try:
                if action == "twin":
                    events.append(FaultEvent(0.0, "twin", {"node": int(args[0])}, clause))
                elif action == "partition":
                    groups = [_parse_group(g) for g in " ".join(args).split("|")]
                    if len(groups) < 2 or any(not g for g in groups):
                        raise ScenarioError(f"partition needs >= 2 non-empty groups: {clause!r}")
                    events.append(FaultEvent(t, "partition", {"groups": groups}, clause))
                elif action == "heal":
                    events.append(FaultEvent(t, "heal", {}, clause))
                elif action in ("kill", "restart"):
                    events.append(FaultEvent(t, action, {"node": int(args[0])}, clause))
                elif action == "link":
                    src_s, dst_s = args[0].split("->", 1)
                    kv = {}
                    for a in args[1:]:
                        k, v = a.split("=", 1)
                        if k not in _LINK_KEYS:
                            raise ScenarioError(f"unknown link key {k!r} in {clause!r}")
                        kv[k] = float(v)
                    events.append(
                        FaultEvent(
                            t, "link",
                            {"src": int(src_s), "dst": int(dst_s), **kv}, clause,
                        )
                    )
                elif action == "skew":
                    events.append(
                        FaultEvent(t, "skew", {"node": int(args[0]), "skew_s": float(args[1])}, clause)
                    )
                elif action == "disk":
                    from .disk import FAULT_KINDS, STORES

                    node, kind = int(args[0]), args[1]
                    kv = {"store": "*", "p": 1.0}
                    for a in args[2:]:
                        k, v = a.split("=", 1)
                        if k == "store":
                            kv["store"] = v
                        elif k == "p":
                            kv["p"] = float(v)
                        else:
                            raise ScenarioError(f"unknown disk key {k!r} in {clause!r}")
                    if kind != "heal" and kind not in FAULT_KINDS:
                        raise ScenarioError(
                            f"unknown disk fault {kind!r} in {clause!r} "
                            f"(want one of {FAULT_KINDS} or heal)"
                        )
                    if kv["store"] != "*" and kv["store"] not in STORES:
                        raise ScenarioError(f"unknown store {kv['store']!r} in {clause!r}")
                    events.append(
                        FaultEvent(t, "disk", {"node": node, "kind": kind, **kv}, clause)
                    )
                elif action == "rot":
                    node, store = int(args[0]), args[1]
                    if store != "blockstore":
                        raise ScenarioError(
                            f"rot supports store 'blockstore' only (got {store!r} in {clause!r})"
                        )
                    kv = {"height": None, "part": 0}
                    for a in args[2:]:
                        k, v = a.split("=", 1)
                        if k == "h":
                            kv["height"] = int(v)
                        elif k == "part":
                            kv["part"] = int(v)
                        else:
                            raise ScenarioError(f"unknown rot key {k!r} in {clause!r}")
                    if kv["height"] is None:
                        raise ScenarioError(f"rot needs h=HEIGHT in {clause!r}")
                    events.append(
                        FaultEvent(t, "rot", {"node": node, "store": store, **kv}, clause)
                    )
                elif action == "valset":
                    if not args:
                        raise ScenarioError(f"valset needs an op in {clause!r}")
                    op = args[0]
                    if op == "join":
                        kv = {"op": "join", "node": int(args[1]), "power": 10}
                        for a in args[2:]:
                            k, v = a.split("=", 1)
                            if k != "power":
                                raise ScenarioError(f"unknown valset join key {k!r} in {clause!r}")
                            kv["power"] = int(v)
                        if kv["power"] <= 0:
                            raise ScenarioError(f"valset join power must be > 0 in {clause!r}")
                        events.append(FaultEvent(t, "valset", kv, clause))
                    elif op == "leave":
                        events.append(
                            FaultEvent(t, "valset", {"op": "leave", "node": int(args[1])}, clause)
                        )
                    elif op == "power":
                        node_s, power_s = args[1].split("=", 1)
                        events.append(
                            FaultEvent(
                                t, "valset",
                                {"op": "power", "node": int(node_s), "power": int(power_s)},
                                clause,
                            )
                        )
                    elif op == "migrate":
                        scheme = args[2] if len(args) > 2 else "bls"
                        if scheme not in ("bls", "bls12381", "ed25519"):
                            raise ScenarioError(
                                f"valset migrate scheme must be bls|bls12381|ed25519 "
                                f"(got {scheme!r} in {clause!r})"
                            )
                        events.append(
                            FaultEvent(
                                t, "valset",
                                {
                                    "op": "migrate",
                                    "node": int(args[1]),
                                    "scheme": "bls12381" if scheme != "ed25519" else "ed25519",
                                },
                                clause,
                            )
                        )
                    else:
                        raise ScenarioError(f"unknown valset op {op!r} in {clause!r}")
                else:
                    raise ScenarioError(f"unknown action {action!r} in {clause!r}")
            except (IndexError, ValueError) as e:
                if isinstance(e, ScenarioError):
                    raise
                raise ScenarioError(f"malformed clause {clause!r}: {e}") from e
        return cls(events, seed=seed, text=text)

    def timeline(self) -> List[FaultEvent]:
        return list(self._timeline)

    def duration(self) -> float:
        return self._timeline[-1].t if self._timeline else 0.0

    def twin_nodes(self) -> List[int]:
        return [e.args["node"] for e in self._timeline if e.action == "twin"]

    def fingerprint(self) -> str:
        """Hash of the RESOLVED timeline — two runs with the same text and
        seed produce the same fingerprint; any drift in jitter resolution
        or parse order changes it.  The chaos-smoke acceptance gate."""
        h = hashlib.sha256()
        for ev in self._timeline:
            h.update(f"{ev.t:.6f}|{ev.action}|{sorted(ev.args.items())}\n".encode())
        return h.hexdigest()


class ScenarioRunner:
    """Plays a resolved timeline against a rig on the event loop clock.
    The rig surface (duck-typed):

        node_count: int
        async set_link(src, dst, policy: LinkPolicy)
        async heal()
        async kill(i) / restart(i)
        async set_skew(i, skew_s)
        async set_disk(i, store, kind, p) / heal_disk(i, store)
        async rot(i, store, height, part)
        async valset(op, i, **kv)    op in join|leave|power|migrate
    """

    def __init__(self, scenario: Scenario, rig, recorder=None):
        self.scenario = scenario
        self.rig = rig
        self.recorder = recorder
        self.log = get_logger("chaos.scenario")
        self.executed: List[FaultEvent] = []

    async def run(self) -> None:
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        for ev in self.scenario.timeline():
            delay = t0 + ev.t - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            self.log.info("fault", event=ev.describe())
            if self.recorder is not None:
                self.recorder.record(f"chaos.{ev.action}", **_flat(ev.args))
            await self._apply(ev)
            self.executed.append(ev)

    async def _apply(self, ev: FaultEvent) -> None:
        a = ev.action
        if a == "twin":
            return  # installed from genesis by config; marker only
        if a == "partition":
            groups = ev.args["groups"]
            for gi, g1 in enumerate(groups):
                for g2 in groups[gi + 1:]:
                    for x in g1:
                        for y in g2:
                            await self.rig.set_link(x, y, PARTITIONED)
                            await self.rig.set_link(y, x, PARTITIONED)
        elif a == "heal":
            await self.rig.heal()
        elif a == "kill":
            await self.rig.kill(ev.args["node"])
        elif a == "restart":
            await self.rig.restart(ev.args["node"])
        elif a == "link":
            pol = degraded(
                drop=ev.args.get("drop", 0.0),
                delay=ev.args.get("delay", 0.0),
                jitter=ev.args.get("jitter", 0.0),
                rate=ev.args.get("rate", 0.0),
            )
            await self.rig.set_link(ev.args["src"], ev.args["dst"], pol)
        elif a == "skew":
            await self.rig.set_skew(ev.args["node"], ev.args["skew_s"])
        elif a == "disk":
            if ev.args["kind"] == "heal":
                await self.rig.heal_disk(ev.args["node"], ev.args["store"])
            else:
                await self.rig.set_disk(
                    ev.args["node"], ev.args["store"], ev.args["kind"], ev.args["p"]
                )
        elif a == "rot":
            await self.rig.rot(
                ev.args["node"], ev.args["store"], ev.args["height"], ev.args["part"]
            )
        elif a == "valset":
            kv = {k: v for k, v in ev.args.items() if k not in ("op", "node")}
            await self.rig.valset(ev.args["op"], ev.args["node"], **kv)
        else:  # parse() already rejects unknown actions
            raise ScenarioError(f"unexecutable action {a!r}")


def _flat(args: dict) -> dict:
    return {k: (str(v) if isinstance(v, (list, dict)) else v) for k, v in args.items()}


class InProcRig:
    """Direct-handle rig over in-process Nodes (the deterministic test
    path).  Link control requires each node to have been built with
    `[chaos] enabled` (so its switch carries a LinkPolicyTable); kill
    stops the node's services; restart needs a caller-supplied factory
    because reconstructing a Node (config, genesis, privval) is the
    test's business."""

    def __init__(self, nodes: Sequence, restart_factory: Optional[Callable] = None):
        self.nodes = list(nodes)
        self.restart_factory = restart_factory
        self.log = get_logger("chaos.rig")

    @property
    def node_count(self) -> int:
        return len(self.nodes)

    def _table(self, i: int):
        table = getattr(self.nodes[i].switch, "link_policies", None)
        if table is None:
            raise RuntimeError(
                f"node {i} has no LinkPolicyTable — build it with [chaos] enabled"
            )
        return table

    async def set_link(self, src: int, dst: int, policy: LinkPolicy) -> None:
        self._table(src).set_policy(self.nodes[dst].node_key.id, policy)

    async def heal(self) -> None:
        for i in range(len(self.nodes)):
            self._table(i).heal()

    async def kill(self, i: int) -> None:
        if self.nodes[i].is_running:
            await self.nodes[i].stop()

    async def restart(self, i: int):
        if self.restart_factory is None:
            raise RuntimeError("InProcRig.restart needs a restart_factory")
        node = await self.restart_factory(i)
        self.nodes[i] = node
        return node

    async def set_skew(self, i: int, skew_s: float) -> None:
        from .clock import SkewedClock

        cs = self.nodes[i].consensus
        if isinstance(cs.clock, SkewedClock):
            cs.clock.set_skew(skew_s)
        else:
            cs.clock = SkewedClock(skew_s)

    # -- disk faults ---------------------------------------------------------

    def _disk_table(self, i: int):
        table = getattr(self.nodes[i], "disk_faults", None)
        if table is None:
            raise RuntimeError(
                f"node {i} has no DiskFaultTable — build it with [chaos] enabled"
            )
        return table

    async def set_disk(self, i: int, store: str, kind: str, p: float = 1.0) -> None:
        from .disk import policy_for

        self._disk_table(i).set_policy(store, policy_for(kind, p))

    async def heal_disk(self, i: int, store: str = "*") -> None:
        self._disk_table(i).heal(None if store == "*" else store)

    async def rot(self, i: int, store: str, height: int, part: int = 0) -> None:
        from .disk import rot_block_store

        if store != "blockstore":
            raise RuntimeError(f"rot supports 'blockstore' only, got {store!r}")
        info = rot_block_store(
            self.nodes[i].block_store, height, seed=self._disk_table(i).seed, part_index=part
        )
        self.log.info("rot injected", node=i, height=height, **info)

    # -- validator-set actions (staking-app tx path) -------------------------
    #
    # Requires proxy_app = "staking".  Every action is a real signed stake
    # tx submitted through a running node's mempool — the set change then
    # flows tx -> end_block.validator_updates -> update_state exactly like
    # production, which is the point: no backdoor set surgery.

    def _privval_keys(self, i: int):
        """All candidate privkeys node i holds (RotatingPV-aware).  Also
        unwraps TwinSigner (`._priv`) and FilePV (`.key.priv_key`) so a
        twin's owner key can still sign stake txs — e.g. `valset leave`
        for a halted equivocator."""
        pv = getattr(self.nodes[i], "priv_validator", None)
        out = []
        for cand in getattr(pv, "candidates", None) or [pv]:
            pk = (
                getattr(cand, "priv_key", None)
                or getattr(cand, "_priv", None)
                or getattr(getattr(cand, "key", None), "priv_key", None)
            )
            if pk is not None:
                out.append(pk)
        return out

    def _owner_key(self, i: int):
        """Node i's ed25519 control key — the envelope signer for every
        stake tx.  Stays fixed across consensus-key migrations (that
        separation is what makes live migration possible)."""
        for pk in self._privval_keys(i):
            if getattr(pk.pub_key(), "TYPE", "") == "tendermint/PubKeyEd25519":
                return pk
        raise RuntimeError(f"node {i} has no ed25519 privval key to sign stake txs")

    def _candidate_key(self, i: int, scheme: str):
        want = (
            "tendermint/PubKeyBLS12381" if scheme == "bls12381"
            else "tendermint/PubKeyEd25519"
        )
        for pk in self._privval_keys(i):
            if getattr(pk.pub_key(), "TYPE", "") == want:
                return pk
        raise RuntimeError(
            f"node {i} holds no {scheme} consensus key — give it a RotatingPV "
            f"with a {scheme} candidate before migrating"
        )

    def _submit_via(self, i: int):
        """Prefer the target node's own mempool; any running node works
        (gossip carries it) when the target is down or partitioned."""
        if self.nodes[i].is_running:
            return self.nodes[i]
        for node in self.nodes:
            if node.is_running:
                return node
        raise RuntimeError("no running node to submit a stake tx through")

    async def _next_nonce(self, node, owner_addr: bytes) -> int:
        from ..abci import types as abci

        res = await node.proxy_app.query().query(
            abci.RequestQuery(path="nonce", data=owner_addr)
        )
        return int(res.value or b"0")

    async def valset(self, op: str, i: int, **kv) -> None:
        from ..apps.staking import (
            make_bond_tx,
            make_edit_power_tx,
            make_rotate_key_tx,
        )

        owner = self._owner_key(i)
        via = self._submit_via(i)
        nonce = await self._next_nonce(via, owner.pub_key().address())
        if op == "join":
            tx = make_bond_tx(owner, int(kv["power"]), nonce)
        elif op == "leave":
            tx = make_edit_power_tx(owner, 0, nonce)
        elif op == "power":
            tx = make_edit_power_tx(owner, int(kv["power"]), nonce)
        elif op == "migrate":
            scheme = kv["scheme"]
            new_key = self._candidate_key(i, scheme)
            pop = new_key.pop() if scheme == "bls12381" else b""
            tx = make_rotate_key_tx(
                owner, scheme, new_key.pub_key().bytes(), nonce, pop=pop
            )
        else:
            raise RuntimeError(f"unknown valset op {op!r}")
        res = await via.mempool.check_tx(tx)
        if res.code != 0:
            raise RuntimeError(f"valset {op} node {i}: stake tx rejected: {res.log}")
        self.log.info("valset tx submitted", op=op, node=i, nonce=nonce)
