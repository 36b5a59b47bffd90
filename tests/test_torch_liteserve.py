"""The port's liteserve gateway (tendermint_tpu_torch/liteserve: witness.py,
sessions.py, bootstrap.py, service.py; node.py `_start_liteserve`; the
`liteserve` command) against the JAX package's, tolerance 0.

Each of tests/test_liteserve.py's witness, session and service scenarios
runs in both packages (the cache's are in tests/test_torch_liteserve_cache.py)
on one chain built from the same secrets in each: 4 validators at power
10, 16 heights.  Witness subsets, session errors (code, message, data)
and the gateways' JSON-RPC answers over HTTP must be equal; what differs
by nature is normalised: session ids (random tokens) and uptime.  No
crypto.batch hook is installed, so both gateways verify on their host
paths, except the node's, whose cache verifies through its engine lane
(the port's on the CPU).

Then: a Node of each package with `liteserve.enable` over the same stores
gives equal `lite_status` and answers; the bootstrap gives up after the
same retries with the same message when the trust root is not stored yet;
the port's `liteserve` command parses the JAX command's flags and exits 1
without a card, before anything starts.
"""

import asyncio
import dataclasses
import json
import os
import re
import subprocess
import sys
import types

import pytest
import torch

import tendermint_tpu.cli as jcli
import tendermint_tpu.config as jconfig
import tendermint_tpu.libs.flowrate as jflowrate
import tendermint_tpu.liteserve as jliteserve
import tendermint_tpu.liteserve.bootstrap as jbootstrap
import tendermint_tpu.liteserve.sessions as jsessions
import tendermint_tpu.node as jnode
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu_torch import cli as pcli
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch import liteserve as pliteserve
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.liteserve import bootstrap as pbootstrap
from tendermint_tpu_torch.rpc import client as pclient
from tendermint_tpu_torch.rpc.jsonrpc import SERVER_OVERLOADED

import test_torch_execution as tex
from test_torch_lite2 import CHAIN, JAX, PERIOD, PORT, SEC, T0

torch.set_num_threads(1)

N, TOP = 4, 16
PORT.liteserve, JAX.liteserve = pliteserve, jliteserve
PORT.sessions = pliteserve.sessions
JAX.sessions = jsessions


@pytest.fixture(autouse=True)
def no_hooks():
    """No process-wide crypto.batch hook in either package."""
    saved = jbatch._verifier, jbatch._indexed_verifier
    for hook in (jbatch, batch_hook):
        hook.set_verifier(None)
        hook.set_indexed_verifier(None)
    try:
        yield
    finally:
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
        jbatch.set_verifier(saved[0])
        jbatch.set_indexed_verifier(saved[1])


class Chain:
    """One package's chain: headers {h: SignedHeader}, sets {h: set}."""

    def __init__(self, ns):
        self.ns = ns
        keys = [ns.PrivKey.from_secret(f"liteserve-{i}".encode()) for i in range(N)]
        self.key_of = {k.pub_key().address(): k for k in keys}
        self.vset = ns.ValidatorSet([ns.Validator.new(k.pub_key(), 10) for k in keys])
        self.headers, self.vals = {}, {}
        last = ns.BlockID()
        for h in range(1, TOP + 1):
            self.headers[h] = self.signed(h, last, bytes([h]) * 32)
            self.vals[h] = self.vset
            last = self.headers[h].commit.block_id

    def signed(self, h, last, app_hash):
        ns = self.ns
        header = ns.Header(
            chain_id=CHAIN, height=h, time_ns=T0 + h * SEC, last_block_id=last,
            validators_hash=self.vset.hash(), next_validators_hash=self.vset.hash(),
            app_hash=app_hash, proposer_address=self.vset.validators[0].address)
        bid = ns.BlockID(header.hash(), ns.PartSetHeader(1, header.hash()))
        sigs = [ns.CommitSig(2, v.address, T0 + h * SEC + i, b"")
                for i, v in enumerate(self.vset.validators)]
        unsigned = ns.Commit(h, 0, bid, sigs)
        sigs = [dataclasses.replace(cs, signature=self.key_of[cs.validator_address].sign(
            unsigned.vote_sign_bytes(CHAIN, i))) for i, cs in enumerate(sigs)]
        return ns.SignedHeader(header, ns.Commit(h, 0, bid, sigs))

    def forged(self, h):
        """A twin at h: the same position and set, another app hash, signed
        by the same keys (what a lying primary with compromised keys serves)."""
        return self.signed(h, self.headers[h].header.last_block_id, b"\xde\xad" * 16)

    def provider(self, headers=None):
        return self.ns.lite2.MockProvider(CHAIN, {**self.headers, **(headers or {})}, self.vals)


_chains = {}


def chain(ns):
    if ns.name not in _chains:
        _chains[ns.name] = Chain(ns)
    return _chains[ns.name]


def now_at(h):
    return lambda: T0 + h * SEC


# -- WitnessPool -------------------------------------------------------------------


def test_witness_rotation_is_seeded_and_equals_jax():
    picks = {}
    for ns in (PORT, JAX):
        provs = [chain(ns).provider() for _ in range(5)]
        pool = ns.liteserve.WitnessPool(seed=7, quorum=2)
        for i, p in enumerate(provs):
            pool.add(p, addr=f"w{i}")
        picks[ns.name] = [[provs.index(p) for p in pool.select()] for _ in range(40)]
        picks[ns.name].append(pool.stats())
    assert picks["port"] == picks["jax"]
    assert {i for sub in picks["port"][:-1] for i in sub} == set(range(5))


def test_witness_error_scoring_equals_jax():
    out = {}
    for ns in (PORT, JAX):
        pool = ns.liteserve.WitnessPool(quorum=2, error_threshold=3)
        a, b = chain(ns).provider(), chain(ns).provider()
        pool.add(a, addr="a")
        pool.add(b, addr="b")
        steps = [pool.report_error(a), pool.report_error(a)]
        pool.report_ok(a)
        steps += [pool.report_error(a), pool.report_error(a), pool.report_error(a)]
        steps.append([p is b for p in pool.providers()])
        steps.append(pool.stats())
        pool.restore(a)
        steps.append(a in pool.providers())
        out[ns.name] = steps
    assert out["port"] == out["jax"]
    assert out["port"][:5] == [False, False, False, False, True]


def test_witness_promote_equals_jax():
    out = {}
    for ns in (PORT, JAX):
        pool = ns.liteserve.WitnessPool(quorum=2)
        a, b = chain(ns).provider(), chain(ns).provider()
        pool.add(a, addr="a")
        pool.add(b, addr="b")
        pool.report_error(a)
        steps = [pool.promote() is b, pool.providers() == [a]]
        pool.demote(a)
        with pytest.raises(LookupError) as ei:
            pool.promote()
        steps.append(str(ei.value))
        out[ns.name] = steps
    assert out["port"] == out["jax"] == [True, True, "witness pool exhausted: nothing to promote"]


# -- SessionManager ----------------------------------------------------------------


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def managers(monkeypatch, **kw):
    """Each package's SessionManager on one injected monotonic clock (the
    JAX module and its token buckets read time.monotonic)."""
    clock = Clock()
    fake = types.SimpleNamespace(monotonic=clock)
    monkeypatch.setattr(jsessions, "time", fake)
    monkeypatch.setattr(jflowrate, "time", fake)
    return clock, {"port": pliteserve.SessionManager(now_fn=clock, **kw),
                   "jax": jliteserve.SessionManager(**kw)}


def err(fn):
    try:
        fn()
    except Exception as e:  # each package's RPCError
        return type(e).__name__, e.code, e.message, e.data
    return None


def test_session_create_validates_root_equals_jax(monkeypatch):
    _, mgrs = managers(monkeypatch)
    out = {name: [err(lambda: m.create("1.2.3.4", 0, b"\x00" * 32)),
                  err(lambda: m.create("1.2.3.4", 5, b"short"))] for name, m in mgrs.items()}
    assert out["port"] == out["jax"]
    assert out["port"][0][:2] == ("RPCError", -32602)


def test_session_table_bound_overload_equals_jax(monkeypatch):
    _, mgrs = managers(monkeypatch, max_sessions=2, idle_timeout_s=3600)
    out = {}
    for name, m in mgrs.items():
        m.create("a", 1, b"\x01" * 32)
        m.create("a", 1, b"\x01" * 32)
        out[name] = err(lambda: m.create("a", 1, b"\x01" * 32))
    assert out["port"] == out["jax"]
    assert out["port"][1] == SERVER_OVERLOADED and out["port"][3] == {"retry_after": 3600}


def test_session_full_table_evicts_idle_first_equals_jax(monkeypatch):
    clock, mgrs = managers(monkeypatch, max_sessions=2, idle_timeout_s=10.0)
    out = {}
    for name, m in mgrs.items():
        clock.t = 1000.0
        s1 = m.create("a", 1, b"\x01" * 32)
        clock.t = 1005.0
        s2 = m.create("a", 1, b"\x01" * 32)
        clock.t = 1012.0  # s1 idle past the timeout, s2 not
        s3 = m.create("a", 1, b"\x01" * 32)
        out[name] = [s1.sid in m.sessions, s2.sid in m.sessions, s3.sid in m.sessions,
                     m.stats()]
    assert out["port"] == out["jax"]
    assert out["port"][:3] == [False, True, True] and out["port"][3]["evicted"] == 1


def test_session_create_rate_limit_per_source_equals_jax(monkeypatch):
    clock, mgrs = managers(monkeypatch, create_rate=1.0, create_burst=2)
    out = {}
    for name, m in mgrs.items():
        clock.t = 1000.0
        m.create("spammer", 1, b"\x01" * 32)
        m.create("spammer", 1, b"\x01" * 32)
        clock.t = 1000.25
        steps = [err(lambda: m.create("spammer", 1, b"\x01" * 32))]
        m.create("friend", 1, b"\x01" * 32)  # its own bucket
        clock.t = 1001.5
        steps.append(err(lambda: m.create("spammer", 1, b"\x01" * 32)))
        out[name] = steps
    assert out["port"] == out["jax"]
    assert out["port"][0][1] == SERVER_OVERLOADED and out["port"][0][3] == {"retry_after": 0.75}
    assert out["port"][1] is None


def test_session_request_bucket_equals_jax(monkeypatch):
    clock, mgrs = managers(monkeypatch, session_rate=1.0, session_burst=2)
    out = {}
    for name, m in mgrs.items():
        clock.t = 1000.0
        s = m.create("a", 1, b"\x01" * 32)
        s.admit()
        s.admit()
        clock.t = 1000.5
        name_err = err(s.admit)
        out[name] = [(*name_err[:2], name_err[2].replace(s.sid, "<sid>"), name_err[3]),
                     s.requests]
    assert out["port"] == out["jax"]
    assert out["port"][0][1] == SERVER_OVERLOADED and out["port"][0][3] == {"retry_after": 0.5}


def test_session_resume_unknown_equals_jax(monkeypatch):
    _, mgrs = managers(monkeypatch)
    out = {name: err(lambda: m.resume("nope")) for name, m in mgrs.items()}
    assert out["port"] == out["jax"] == ("RPCError", -32602, "unknown or expired session 'nope'",
                                         "")


# -- the gateways end to end -----------------------------------------------------


def service(ns, primary=None, n_witnesses=3, **kw):
    c = chain(ns)
    return ns.liteserve.LiteServe(
        CHAIN, ns.lite2.TrustOptions(PERIOD, 1, c.headers[1].header.hash()),
        primary or c.provider(), [c.provider() for _ in range(n_witnesses)],
        laddr="tcp://127.0.0.1:0", now_fn=now_at(TOP + 1), witness_timeout_s=0.5,
        witness_addrs=[f"w{i}" for i in range(n_witnesses)], primary_addr="primary", **kw)


async def rpc(addr, method, **params):
    """One JSON-RPC POST over a fresh connection: (status, JSON body)."""
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": params}).encode()
    writer.write(b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(body) + body)
    try:
        status, _, raw = await asyncio.wait_for(pclient._read_response(reader), 30.0)
    finally:
        writer.close()
    return status, json.loads(raw)


async def get(addr, path):
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode())
    try:
        status, headers, raw = await asyncio.wait_for(pclient._read_response(reader), 30.0)
    finally:
        writer.close()
    return status, headers.get("content-type"), raw


def norm(x, sids):
    """Session ids -> their order of appearance; uptime dropped."""
    if isinstance(x, dict):
        return {k: norm(v, sids) for k, v in x.items() if k != "uptime_s"}
    if isinstance(x, (list, tuple)):
        return [norm(v, sids) for v in x]
    if isinstance(x, str):
        for i, sid in enumerate(sids):
            x = x.replace(sid, f"<session {i}>")
    return x


async def both(scenario):
    """Run `scenario(ns, svc_factory)` on each package; return the normalised
    transcripts."""
    out = {}
    for ns in (PORT, JAX):
        sids = []
        transcript = await scenario(ns, sids)
        out[ns.name] = norm(transcript, sids)
    return out


async def test_sessions_share_one_engine_equals_jax():
    async def scenario(ns, sids):
        svc = service(ns)
        await svc.start()
        try:
            base = svc.listen_addr
            root = chain(ns).headers[2].header.hash().hex()
            log = []
            for _ in range(4):
                st, res = await rpc(base, "lite_session_new", trust_height=2, trust_hash=root)
                sids.append(res["result"]["session"])
                log.append((st, res))
            outs = await asyncio.gather(*(rpc(base, "lite_commit", session=sid, height=9)
                                          for sid in sids))
            log.append(outs)
            log.append(await rpc(base, "lite_status"))
            log.append(await rpc(base, "lite_session_resume", session=sids[0]))
            log.append(await rpc(base, "lite_commit", session="bogus", height=3))
            log.append(await rpc(base, "lite_validators", session=sids[1], height=9))
            log.append(await rpc(base, "lite_block", session=sids[1], height=9))
            log.append(await rpc(base, "lite_nope"))
            log.append(await get(base, "/lite_status"))
            log.append(await get(base, "/lite_commit?session=bogus&height=3"))
            log.append(await get(base, "/metrics"))
            log.append(await get(base, "/"))
            status = log[5][1]["result"]
        finally:
            await svc.stop()
        assert status["verify"]["hits"] >= 3 and status["verify"]["hit_ratio"] > 0.5
        assert status["sessions"]["sessions"] == 4
        return log

    out = await both(scenario)
    got, want = out["port"], out["jax"]
    # the two GET /lite_status bodies hold uptime; compare them parsed
    for log in (got, want):
        st, ctype, raw = log[11]
        log[11] = (st, ctype, norm(json.loads(raw), []))
    assert got == want
    assert all("result" in o for _, o in got[4])


async def test_bad_trust_root_rejected_equals_jax():
    async def scenario(ns, sids):
        svc = service(ns)
        await svc.start()
        try:
            res = await rpc(svc.listen_addr, "lite_session_new", trust_height=2,
                            trust_hash="ab" * 32)
            return [res, len(svc.sessions.sessions)]
        finally:
            await svc.stop()

    out = await both(scenario)
    assert out["port"] == out["jax"]
    assert "conflicts" in out["port"][0][1]["error"]["message"] and out["port"][1] == 0


async def test_concurrent_same_height_coalesce_equals_jax():
    async def scenario(ns, sids):
        class SlowProvider(ns.lite2.MockProvider):
            async def signed_header(self, height):
                await asyncio.sleep(0.002)
                return await super().signed_header(height)

        c = chain(ns)
        svc = service(ns, primary=SlowProvider(CHAIN, c.headers, c.vals))
        await svc.start()
        try:
            got = await asyncio.gather(*(svc.verified_header(12) for _ in range(8)))
            return [[sh.header.hash().hex() for sh in got], svc.lookup_misses,
                    svc.coalesced_requests, svc.lookup_hits, svc.cache.stats()]
        finally:
            await svc.stop()

    out = await both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 1 and out["port"][2] >= 1 and sum(out["port"][1:4]) == 8


async def test_adversarial_primary_demoted_and_replaced_equals_jax():
    async def scenario(ns, sids):
        c = chain(ns)
        evil = c.provider({10: c.forged(10)})
        svc = service(ns, primary=evil)
        await svc.start()
        try:
            base = svc.listen_addr
            root = c.headers[2].header.hash().hex()
            log = [await rpc(base, "lite_session_new", trust_height=2, trust_hash=root)]
            sids.append(log[0][1]["result"]["session"])
            for h in (5, 10, 14):
                log.append(await rpc(base, "lite_commit", session=sids[0], height=h))
            log.append(await rpc(base, "lite_status"))
            assert svc.client.primary is not evil
            assert all(svc.store.signed_header(h).header.hash() == c.headers[h].header.hash()
                       for h in svc.store.heights())
            events = [e["kind"] for e in svc.recorder.events()
                      if e["kind"].startswith("liteserve.") and e["kind"] != "liteserve.bisection"]
            return log + [events]
        finally:
            await svc.stop()

    out = await both(scenario)
    assert out["port"] == out["jax"]
    status = out["port"][4][1]["result"]
    assert status["verify"]["primary_replacements"] == 1
    assert status["verify"]["demoted_primaries"] == ["primary"]
    assert all("result" in r for _, r in out["port"][1:4])
    assert "liteserve.demote_primary" in out["port"][5]


async def test_overload_surfaces_minus_32005_equals_jax():
    async def scenario(ns, sids):
        svc = service(ns, max_sessions=1)
        await svc.start()
        try:
            root = chain(ns).headers[2].header.hash().hex()
            first = await rpc(svc.listen_addr, "lite_session_new", trust_height=2,
                              trust_hash=root)
            sids.append(first[1]["result"]["session"])
            return [first, await rpc(svc.listen_addr, "lite_session_new", trust_height=2,
                                     trust_hash=root)]
        finally:
            await svc.stop()

    out = await both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][1][1]["error"]["code"] == SERVER_OVERLOADED


async def test_http_front_bounds_equal_jax():
    """The gateway's HTTP front: an over-cap body, junk, a batch and a
    non-object params answer as the JAX gateway's."""
    bodies = [b"x" * 5000, b"\xff junk", b"[1, 2]",
              b'{"jsonrpc": "2.0", "id": 3, "method": "lite_status", "params": [1]}']

    async def scenario(ns, sids):
        svc = service(ns, max_body_bytes=4000)
        await svc.start()
        out = []
        try:
            host, port = svc.listen_addr.rsplit(":", 1)
            for body in bodies:
                r, w = await asyncio.open_connection(host, int(port))
                w.write(b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                        % len(body) + body)
                status, _, raw = await pclient._read_response(r)
                w.close()
                out.append((status, json.loads(raw)))
        finally:
            await svc.stop()
        return out

    out = await both(scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0][1]["error"] == {"code": -32600,
                                          "message": "request body exceeds 4000 bytes"}


# -- bootstrap, the node and the command ------------------------------------------


async def test_bootstrap_gives_up_identically_when_the_root_is_not_stored(monkeypatch):
    """The trust root's header is not served yet: five attempts, the same
    backoff (0.3 s, 0.6 s, ... as the JAX module) and the same error."""
    out = {}
    for ns, mod in ((PORT, pbootstrap), (JAX, jbootstrap)):
        sleeps = []

        async def fake_sleep(s, sleeps=sleeps):
            sleeps.append(round(s, 3))

        monkeypatch.setattr(mod.asyncio, "sleep", fake_sleep)
        c = chain(ns)
        client = ns.lite2.Client(
            CHAIN, ns.lite2.TrustOptions(PERIOD, 14, c.headers[14].header.hash()),
            ns.lite2.MockProvider(CHAIN, {h: c.headers[h] for h in range(1, 6)}, c.vals),
            now_fn=now_at(TOP + 1))
        with pytest.raises(Exception) as ei:
            await mod.snapshot_bootstrap(client)
        monkeypatch.undo()
        out[ns.name] = (type(ei.value).__name__, str(ei.value), sleeps)
    assert out["port"] == out["jax"]
    assert out["port"][2] == [0.3, 0.6, 0.9, 1.2, 1.5]
    assert out["port"][1].startswith("liteserve bootstrap failed after 5 attempts")


def gateway_node(ns, home, root_hash):
    """A node of the package (tests/test_torch_execution's namespace) over
    run_chain's sqlite stores, with no validator key and p2p and RPC off,
    and `liteserve.enable` rooted at height 2.  The JAX node verifies on its
    host path, the port's on its engine (the kernels' plain versions)."""
    config = pconfig if ns is tex.PORT else jconfig
    cfg = config.test_config(home)
    cfg.p2p.laddr, cfg.rpc.laddr = "none", ""
    cfg.liteserve.enable = True
    cfg.liteserve.laddr = "tcp://127.0.0.1:0"
    cfg.liteserve.trust_height = 2
    cfg.liteserve.trust_hash = root_hash.hex()
    cfg.liteserve.trust_period = 100 * 365 * 24 * 3600.0  # the chain's time is 2023's
    gen = tex.genesis(ns, tex.chain_keys(ns))
    if ns is tex.PORT:
        cfg.tpu.enabled = True
        return pnode.Node(cfg, gen, device="cpu")
    return jnode.Node(cfg, gen)


async def test_node_liteserve_status_equals_jax(tmp_path):
    """Node.start runs `_start_liteserve` in each package: the bootstrap
    from the LocalProvider (root 2, tip 6), then equal answers."""
    out = {}
    for ns in (tex.PORT, tex.JAX):
        home = str(tmp_path / ns.name)
        await tex.run_chain(ns, home=home)
        db = ns.kvstore.open_db("blockstore", home)
        root = ns.BlockStore(db).load_block_meta(2).header.hash()
        db.close()
        node = gateway_node(ns, home, root)
        await node.start()
        sids = []
        try:
            base = node.liteserve.listen_addr
            log = [await rpc(base, "lite_status")]
            st, res = await rpc(base, "lite_session_new", trust_height=2, trust_hash=root.hex())
            sids.append(res["result"]["session"])
            log.append((st, res))
            log.append(await rpc(base, "lite_commit", session=sids[0], height=4))
            log.append(await rpc(base, "lite_status"))
            if ns is tex.PORT:
                assert node.liteserve.cache.async_verifier is node.async_verifier
        finally:
            await node.stop()
        out[ns.name] = norm(log, sids)
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)
    assert out["port"] == out["jax"]
    status = out["port"][-1][1]["result"]
    assert status["primary"] == "local" and status["first_trusted_height"] == 2
    assert status["latest_trusted_height"] == tex.HEIGHTS


def test_liteserve_command_parses_the_jax_flags():
    argv = ["liteserve", "--chain-id", "c", "--primary", "127.0.0.1:26657",
            "--witnesses", "127.0.0.1:1,127.0.0.1:2", "--laddr", "tcp://127.0.0.1:0",
            "--height", "2", "--hash", "ab" * 32, "--trusting-period", "60",
            "--cache-capacity", "8", "--max-sessions", "9", "--session-rate", "1.5",
            "--session-burst", "3", "--create-rate", "2", "--create-burst", "4",
            "--witness-quorum", "1", "--witness-timeout", "0.5", "--rotation-seed", "7",
            "--metrics-laddr", "x"]
    p = vars(pcli.build_parser().parse_args(argv))
    j = vars(jcli.build_parser().parse_args(argv))
    assert p.pop("fn").__name__ == j.pop("fn").__name__ == "cmd_liteserve"
    p.pop("home"), j.pop("home")
    assert p == j
    defaults = ["liteserve", "--chain-id", "c", "--primary", "p", "--height", "1", "--hash", "00"]
    p = vars(pcli.build_parser().parse_args(defaults))
    j = vars(jcli.build_parser().parse_args(defaults))
    for d in (p, j):
        d.pop("fn"), d.pop("home")
    assert p == j


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_liteserve_command_exits_without_a_card(monkeypatch, capsys):
    started = []
    monkeypatch.setattr(pliteserve.service, "run_service",
                        lambda *a, **k: started.append(a))
    rc = pcli.main(["liteserve", "--chain-id", "c", "--primary", "127.0.0.1:1",
                    "--height", "2", "--hash", "ab" * 32])
    assert rc == 1 and started == []
    assert "CUDA is not available" in capsys.readouterr().err
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch", "liteserve",
                          "--chain-id", "c", "--primary", "127.0.0.1:1", "--height", "2",
                          "--hash", "ab" * 32], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1 and re.search("CUDA is not available", out.stderr)
