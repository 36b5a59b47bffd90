"""The port's remote signer (tendermint_tpu_torch/privval/signer.py) and
its harness (tools/signer_harness.py) against the JAX package's, tolerance
exact; then a port node whose app and key are both across a process
boundary.

- Each package's SignerClient takes the other's SignerServer (and its own)
  over tcp (SecretConnection) and unix: proposals, prevotes and precommits
  signed remotely carry the signature a local FilePV with the same key
  gives, and a conflicting vote at the same height, round and step is
  refused with the JAX FilePV's text.
- A signer that reconnects with the same key passes the challenge and takes
  the connection over; one with another key is rejected, and so is one that
  states the validator key without proving it (its challenge signature is
  another key's).  Nonces come from `nonce_fn`, connection keys from
  `conn_key`, both seeded here.
- The harness gives the JAX lines and exit code against an honest signer,
  and fails with the JAX check name (DoubleSign) against one that signs
  anything.
- A port node at 1 validator on device="cpu", its app behind `python -m
  tendermint_tpu_torch.abci_cli kvstore` in a subprocess and its key behind
  a SignerServer, commits 3 heights; its app hash equals the in-proc
  kvstore's over the same blocks' txs.
"""

import asyncio
import contextlib
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

import tendermint_tpu.privval.file as jfile
import tendermint_tpu.privval.signer as jsigner
import tendermint_tpu.tools.signer_harness as jharness
import tendermint_tpu.types.block as jblock
import tendermint_tpu.types.priv_validator as jpv
import tendermint_tpu.types.proposal as jproposal
import tendermint_tpu.types.vote as jvote
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.abci import examples as pexamples
from tendermint_tpu_torch.abci import types as pabci
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.privval import file as pfile
from tendermint_tpu_torch.privval import signer as psigner
from tendermint_tpu_torch.tools import signer_harness as pharness
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import priv_validator as ppv
from tendermint_tpu_torch.types import proposal as pproposal
from tendermint_tpu_torch.types import vote as pvote
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE

torch.set_num_threads(1)

PORT = types.SimpleNamespace(name="port", PrivKey=Ed25519PrivKey, file=pfile, signer=psigner,
                             harness=pharness, block=pblock, proposal=pproposal, vote=pvote,
                             pv=ppv)
JAX = types.SimpleNamespace(name="jax", PrivKey=JPrivKey, file=jfile, signer=jsigner,
                            harness=jharness, block=jblock, proposal=jproposal, vote=jvote,
                            pv=jpv)
PKGS = {"port": PORT, "jax": JAX}
CHAIN = "signer-parity"
T0 = 1_700_000_000 * 10**9


def file_pv(ns, tmp, secret=b"signer-ours", tag=""):
    key = ns.PrivKey.from_secret(secret)
    pv = ns.file.FilePV(
        ns.file.FilePVKey(key.pub_key().address(), key.pub_key(), key,
                          os.path.join(tmp, f"key{tag}.json")),
        ns.file.FilePVLastSignState(file_path=os.path.join(tmp, f"state{tag}.json")))
    pv.save()
    return pv


def vote(ns, addr, h, kind, blk=b"\x01" * 32):
    bid = ns.block.BlockID(blk, ns.block.PartSetHeader(1, b"\x02" * 32))
    return ns.vote.Vote(kind, h, 0, bid, T0 + h, addr, 0)


def proposal(ns, h):
    bid = ns.block.BlockID(b"\x01" * 32, ns.block.PartSetHeader(1, b"\x02" * 32))
    return ns.proposal.Proposal(height=h, round=0, block_id=bid, timestamp_ns=T0 + h)


def seeded(seed):
    rng = np.random.default_rng(seed)
    return lambda n: rng.bytes(n)


def laddr(transport, tmp):
    if transport == "unix":
        return f"unix://{os.path.join(tmp, 'pv.sock')}"
    return "tcp://127.0.0.1:0"


async def listening(client):
    """Start `client` (it waits for a signer); return the task and the
    address a signer dials."""
    task = asyncio.ensure_future(client.start())
    for _ in range(2000):
        if client.listen_addr:
            return task, client.listen_addr
        await asyncio.sleep(0.005)
    raise AssertionError("the signer client does not listen")


async def signatures(ns, client):
    """A proposal, a prevote and a precommit signed through `client`, and
    the refusal of a conflicting precommit."""
    addr = client.get_pub_key().address()
    p = proposal(ns, 5)
    await client.sign_proposal(CHAIN, p)
    out = [p.signature]
    for kind in (PREVOTE_TYPE, PRECOMMIT_TYPE):
        v = vote(ns, addr, 5, kind)
        await client.sign_vote(CHAIN, v)
        out.append(v.signature)
    with pytest.raises(ns.signer.RemoteSignerError) as e:
        await client.sign_vote(CHAIN, vote(ns, addr, 5, PRECOMMIT_TYPE, b"\x0f" * 32))
    out.append(str(e.value))
    return out


def local_signatures(ns, tmp):
    pv = file_pv(ns, tmp, tag="-local")
    addr = pv.get_pub_key().address()
    p = proposal(ns, 5)
    pv.sign_proposal(CHAIN, p)
    out = [p.signature]
    for kind in (PREVOTE_TYPE, PRECOMMIT_TYPE):
        v = vote(ns, addr, 5, kind)
        pv.sign_vote(CHAIN, v)
        out.append(v.signature)
    with pytest.raises(ns.file.DoubleSignError) as e:
        pv.sign_vote(CHAIN, vote(ns, addr, 5, PRECOMMIT_TYPE, b"\x0f" * 32))
    return out + [str(e.value)]


@pytest.mark.parametrize("transport", ["tcp", "unix"])
@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port"), ("port", "port")])
async def test_remote_signing_across_packages(transport, client_pkg, server_pkg):
    c, s = PKGS[client_pkg], PKGS[server_pkg]
    with tempfile.TemporaryDirectory() as tmp:
        kw = {"conn_key": c.PrivKey.from_secret(b"conn-client"), "nonce_fn": seeded(1)} \
            if c is PORT else {}
        client = c.signer.SignerClient(laddr(transport, tmp), **kw)
        task, addr = await listening(client)
        skw = {"conn_key": s.PrivKey.from_secret(b"conn-server")} if s is PORT else {}
        server = s.signer.SignerServer(addr, file_pv(s, tmp), **skw)
        await server.start()
        await task
        try:
            got = await signatures(c, client)
            await client.ping()
        finally:
            await client.stop()
            await server.stop()
        want = local_signatures(JAX, tmp)
    assert got == want
    assert want[-1] == "conflicting data: same HRS, different vote"


async def _until(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


class Impostor(ppv.MockPV):
    """States the validator's key; signs its challenges with another."""

    def __init__(self, stated, real):
        super().__init__(real)
        self._stated = stated

    def get_pub_key(self):
        return self._stated


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
async def test_reconnect_is_pinned_to_the_validator_key(server_pkg):
    s = PKGS[server_pkg]
    with tempfile.TemporaryDirectory() as tmp:
        client = psigner.SignerClient("tcp://127.0.0.1:0", nonce_fn=seeded(7))
        task, addr = await listening(client)
        first = s.signer.SignerServer(addr, file_pv(s, tmp))
        await first.start()
        await task
        servers = [first]
        try:
            honest = client._conn
            # another validator key: rejected, the honest link stays
            other = s.signer.SignerServer(addr, file_pv(s, tmp, b"signer-other", "-o"))
            # the validator's key stated, its possession not proven
            key = s.PrivKey.from_secret(b"signer-ours")
            impostor_pv = Impostor(key.pub_key(), Ed25519PrivKey.from_secret(b"x")) \
                if s is PORT else types.SimpleNamespace(
                    get_pub_key=key.pub_key,
                    sign_challenge=JPrivKey.from_secret(b"x").sign)
            impostor = s.signer.SignerServer(addr, impostor_pv)
            for bad in (other, impostor):
                servers.append(bad)
                await bad.start()
                await _until(lambda: bad._task.done(), "the rejected signer's disconnect")
                assert client._conn is honest
            v = vote(PORT, client.get_pub_key().address(), 9, PREVOTE_TYPE)
            await client.sign_vote(CHAIN, v)
            assert client.get_pub_key().verify(v.sign_bytes(CHAIN), v.signature)
            # the same key after the honest signer went away: accepted
            await first.stop()
            again = s.signer.SignerServer(addr, s.file.FilePV.load(
                os.path.join(tmp, "key.json"), os.path.join(tmp, "state.json")))
            servers.append(again)
            await again.start()
            await _until(lambda: client._conn is not honest, "the reconnect")
            v = vote(PORT, client.get_pub_key().address(), 10, PREVOTE_TYPE)
            await client.sign_vote(CHAIN, v)
            assert client.get_pub_key().verify(v.sign_bytes(CHAIN), v.signature)
        finally:
            await client.stop()
            for srv in servers:
                await srv.stop()


# -- the harness ---------------------------------------------------------------------


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def signer_in_thread(ns, addr, pv):
    """A SignerServer dialing `addr` from a loop of its own thread (the
    harness's main runs asyncio.run); its dial retries cover the harness's
    start."""
    loop = asyncio.new_event_loop()
    box = {}

    def run():
        asyncio.set_event_loop(loop)
        box["server"] = ns.signer.SignerServer(addr, pv, retries=100, retry_interval=0.05)
        try:
            loop.run_until_complete(box["server"].start())
        except Exception as e:  # noqa: BLE001 — reported by the test
            box["error"] = e
            return
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        yield box
    finally:
        if "server" in box and box["server"].is_running:
            asyncio.run_coroutine_threadsafe(box["server"].stop(), loop).result(30)
        if loop.is_running():
            loop.call_soon_threadsafe(loop.stop)
        th.join(30)
        loop.close()


FIXED_TIME = types.SimpleNamespace(time=lambda: 1_700_000_123.0, time_ns=lambda: T0 + 123)


@pytest.mark.parametrize("honest", [True, False])
def test_harness_lines_and_exit_codes_equal_jax(honest, capsys, monkeypatch):
    outs = {}
    for ns in (PORT, JAX):
        monkeypatch.setattr(ns.harness, "time", FIXED_TIME)
        with tempfile.TemporaryDirectory() as tmp:
            pv = file_pv(ns, tmp) if honest else ns.pv.MockPV(ns.PrivKey.from_secret(b"any"))
            addr = f"tcp://127.0.0.1:{free_port()}"
            with signer_in_thread(ns, addr, pv) as box:
                rc = ns.harness.main(["--laddr", addr, "--accept-timeout", "20"])
            assert "error" not in box
        outs[ns.name] = (rc, capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    rc, out = outs["port"]
    if honest:
        assert rc == 0 and [ln.split(" ")[1] for ln in out.splitlines()] == [
            "PubKey", "SignProposal", "SignVote", "DoubleSign"]
        assert "refused: conflicting data: same HRS, different vote" in out
    else:
        assert (rc, out) == (1, "FAIL DoubleSign: conflicting vote was SIGNED\n")


def test_harness_without_a_signer_fails_as_jax():
    for ns in (PORT, JAX):
        addr = f"tcp://127.0.0.1:{free_port()}"
        with pytest.raises(ns.signer.RemoteSignerError,
                           match=r"no remote signer connected within 0.2s"):
            asyncio.run(ns.harness.run_harness(addr, accept_timeout=0.2))


# -- a node across both boundaries -----------------------------------------------------


async def test_node_with_socket_app_and_remote_signer_commits(tmp_path):
    home = str(tmp_path / "home")
    app_port, pv_port = free_port(), free_port()
    ours = Ed25519PrivKey.from_secret(b"signer-node")
    cfg = pconfig.test_config(home)
    cfg.base.chain_id = CHAIN
    cfg.p2p.laddr, cfg.rpc.laddr = "none", ""
    cfg.tpu.enabled = True
    cfg.base.proxy_app = f"tcp://127.0.0.1:{app_port}"
    cfg.base.priv_validator_laddr = f"tcp://127.0.0.1:{pv_port}"
    cfg.ensure_dirs()
    gen = pgenesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        pgenesis.GenesisValidator(ours.pub_key().address(), ours.pub_key(), 10, "v0")])
    gen.save_as(cfg.genesis_file())
    signer_dir = str(tmp_path / "signer")
    os.makedirs(signer_dir)
    pv = pfile.FilePV(
        pfile.FilePVKey(ours.pub_key().address(), ours.pub_key(), ours,
                        os.path.join(signer_dir, "key.json")),
        pfile.FilePVLastSignState(file_path=os.path.join(signer_dir, "state.json")))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=root)
    app = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.abci_cli", "--address",
         cfg.base.proxy_app, "kvstore"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=root)
    signer = psigner.SignerServer(cfg.base.priv_validator_laddr, pv, retries=200,
                                  retry_interval=0.05)
    node = None
    try:
        line = await asyncio.get_running_loop().run_in_executor(None, app.stdout.readline)
        assert line.startswith("ABCI KVStoreApplication serving on"), line
        node = pnode.default_new_node(cfg, device="cpu")
        assert isinstance(node.priv_validator, psigner.SignerClient)
        await asyncio.gather(node.start(), signer.start())
        assert node.priv_validator.get_pub_key().bytes() == ours.pub_key().bytes()
        for i in range(6):
            res = await node.mempool.check_tx(b"k%d=v%d" % (i, i))
            assert res.code == 0
        await _until(lambda: node.block_store.height() >= 3, "height 3", timeout=60)
    finally:
        if node is not None and node.is_running:
            await node.stop()
        await signer.stop()
        app.send_signal(signal.SIGINT)
        rc = await asyncio.get_running_loop().run_in_executor(None, lambda: app.wait(30))
    assert rc == 0
    assert not node.priv_validator.is_running
    assert batch_hook.get_indexed_verifier() is None
    state = node.state_store.load()
    top = state.last_block_height
    assert top >= 3
    # the same blocks' txs through the in-proc kvstore
    local = pexamples.KVStoreApplication()
    local.init_chain(pabci.RequestInitChain(validators=[
        pabci.ValidatorUpdate("ed25519", ours.pub_key().bytes(), 10)]))
    txs = []
    for h in range(1, top + 1):
        block = node.block_store.load_block(h)
        assert block.header.proposer_address == ours.pub_key().address()
        local.begin_block(pabci.RequestBeginBlock(hash=block.hash()))
        for tx in block.txs:
            txs.append(tx)
            local.deliver_tx(pabci.RequestDeliverTx(tx=tx))
        local.end_block(pabci.RequestEndBlock(height=h))
        local.commit(pabci.RequestCommit())
    assert sorted(txs) == sorted(b"k%d=v%d" % (i, i) for i in range(6))
    assert state.app_hash == local.app_hash
    # every block's commit carries the remote signer's precommit
    for h in range(2, top + 1):
        sig = node.block_store.load_block(h).last_commit.signatures[0]
        assert sig.signature and sig.validator_address == ours.pub_key().address()


def test_boundary_modules_import_nothing_foreign():
    code = ("import sys; import tendermint_tpu_torch.privval, tendermint_tpu_torch.tools."
            "signer_harness, tendermint_tpu_torch.abci_cli, tendermint_tpu_torch.lite2.proxy, "
            "tendermint_tpu_torch.libs.metrics, tendermint_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('msgpack', 'jax', "
            "'tendermint_tpu', 'aiohttp', 'grpc')]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
