"""The port's ABCI layer (tendermint_tpu_torch: abci/types.py, abci/client.py's
LocalClient, abci/examples.py, proxy.py) against the JAX package's, and
phase 8 of chip_smoke.py end to end at 7 validators on the CPU.

Both packages' apps take the same seeded request sequences over
LocalClient and AppConns; every response (as a dict) must be equal.
The request/response dataclasses round-trip through the socket message
layout (encode_msg / decode_msg) packed by each package's msgpack, with
equal bytes.
"""

import base64
import dataclasses
import os
import subprocess
import sys

import msgpack
import numpy as np
import pytest
import torch

import tendermint_tpu.abci.client as jclient
import tendermint_tpu.abci.examples as jexamples
import tendermint_tpu.abci.types as jabci
import tendermint_tpu.libs.kvstore as jkvstore
import tendermint_tpu.proxy as jproxy
from tendermint_tpu_torch import proxy as pproxy
from tendermint_tpu_torch.abci import client as pclient
from tendermint_tpu_torch.abci import examples as pexamples
from tendermint_tpu_torch.abci import types as pabci
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.encoding import msgpack as pmsgpack
from tendermint_tpu_torch.libs import kvstore as pkvstore

torch.set_num_threads(1)

PKGS = {
    "port": (pabci, pclient, pexamples, pproxy, pkvstore),
    "jax": (jabci, jclient, jexamples, jproxy, jkvstore),
}


def _sample(cls, abci, rng):
    """An instance of an ABCI message class with every field set from rng."""
    kw = {}
    for f in dataclasses.fields(cls):
        t = str(f.type)
        if f.name in ("validators", "validator_updates"):
            kw[f.name] = [abci.ValidatorUpdate("ed25519", rng.bytes(32), int(rng.integers(0, 99)))
                          for _ in range(2)]
        elif f.name == "events":
            kw[f.name] = [abci.Event("app", [{"key": b"k", "value": rng.bytes(4)}])]
        elif f.name == "last_commit_info":
            kw[f.name] = abci.LastCommitInfo(1, [{"address": rng.bytes(20), "power": 10,
                                                  "signed_last_block": True}])
        elif f.name == "snapshots":
            kw[f.name] = [abci.Snapshot(3, 1, 2, rng.bytes(32), rng.bytes(8))]
        elif f.name == "snapshot":
            kw[f.name] = abci.Snapshot(5, 1, 4, rng.bytes(32), rng.bytes(8))
        elif t in ("bytes",):
            kw[f.name] = rng.bytes(int(rng.integers(0, 40)))
        elif t in ("str",):
            kw[f.name] = f"{f.name}-{int(rng.integers(0, 1000))}"
        elif t in ("int",):
            kw[f.name] = int(rng.integers(0, 1 << 40))
        elif t in ("bool",):
            kw[f.name] = bool(rng.integers(0, 2))
        elif "dict" in t and "List" not in t:
            kw[f.name] = {"block": {"max_bytes": int(rng.integers(1, 1 << 20))}}
        elif "List[dict]" in t:
            kw[f.name] = [{"height": int(rng.integers(1, 9)), "address": rng.bytes(20)}]
        elif "List[int]" in t:
            kw[f.name] = [int(x) for x in rng.integers(0, 9, 3)]
        elif "List[str]" in t:
            kw[f.name] = ["peer-a", "peer-b"]
    return cls(**kw)


@pytest.mark.parametrize("kind", sorted(pabci._MSG_TYPES))
def test_messages_round_trip_as_jax(kind):
    """Every request and response class: same fields, encode_msg dicts and
    packed bytes equal to the JAX package's, and decode_msg restores it."""
    for direction in (0, 1):
        pcls, jcls = pabci._MSG_TYPES[kind][direction], jabci._MSG_TYPES[kind][direction]
        if pcls is None:
            assert jcls is None
            continue
        assert [f.name for f in dataclasses.fields(pcls)] == [f.name for f in dataclasses.fields(jcls)]
        ours = _sample(pcls, pabci, np.random.default_rng(len(kind) + direction))
        theirs = _sample(jcls, jabci, np.random.default_rng(len(kind) + direction))
        d, jd = pabci.encode_msg(kind, ours), jabci.encode_msg(kind, theirs)
        assert d == jd
        raw = pmsgpack.packb(d)
        assert raw == msgpack.packb(jd, use_bin_type=True)
        back_kind, back = pabci.decode_msg(pmsgpack.unpackb(raw), direction)
        assert back_kind == kind and back == ours
        j_kind, j_back = jabci.decode_msg(msgpack.unpackb(raw, raw=False), direction)
        assert dataclasses.asdict(j_back) == dataclasses.asdict(back)


def test_response_codes_and_defaults_match_jax():
    for name in ("ResponseQuery", "ResponseCheckTx", "ResponseDeliverTx"):
        for code in (0, 1):
            p, j = getattr(pabci, name)(code=code), getattr(jabci, name)(code=code)
            assert p.is_ok == j.is_ok == (code == 0)
    assert pabci.CODE_TYPE_OK == jabci.CODE_TYPE_OK
    assert (pabci.CheckTxType.NEW, pabci.CheckTxType.RECHECK) == (0, 1)
    for cls in ("OfferSnapshotResult", "ApplySnapshotChunkResult"):
        def codes(mod):
            return {k: v for k, v in vars(getattr(mod, cls)).items() if k.isupper()}

        assert codes(pabci) == codes(jabci) and codes(pabci)
    for name in ("Application", "BaseApplication"):
        app_p, app_j = getattr(pabci, name), getattr(jabci, name)
        methods = [m for m in vars(jabci.Application) if not m.startswith("_")]
        assert [m for m in vars(pabci.Application) if not m.startswith("_")] == methods
        if name == "BaseApplication":
            assert dataclasses.asdict(app_p().echo(pabci.RequestEcho("hi"))) == \
                dataclasses.asdict(app_j().echo(jabci.RequestEcho("hi")))


async def _kvstore_session(pkg, snapshot_interval=2):
    """A seeded session of the kvstore app over AppConns: InitChain, three
    blocks (kv txs, val: txs adding and removing validators, an invalid val
    tx, byzantine validators), queries and the snapshot protocol into a
    second app.  Every response as a dict."""
    abci, client, examples, proxy, kvstore = PKGS[pkg]
    rng = np.random.default_rng(5)
    app = examples.KVStoreApplication(db=kvstore.MemDB(), snapshot_interval=snapshot_interval,
                                      snapshot_chunk_bytes=64, retain_blocks=2)
    conns = proxy.AppConns(proxy.local_client_creator(app))
    await conns.start()
    out = []
    try:
        c, m, q = conns.consensus(), conns.mempool(), conns.query()
        pks = [rng.bytes(32) for _ in range(4)]
        out.append(await c.init_chain(abci.RequestInitChain(
            chain_id="abci-parity", validators=[abci.ValidatorUpdate("ed25519", pk, 10)
                                                for pk in pks[:3]])))
        out.append(await q.info(abci.RequestInfo()))
        out.append(await q.echo("ping"))
        for h in range(1, 4):
            txs = [b"k%d-%d=%s" % (h, i, rng.bytes(4).hex().encode()) for i in range(3)]
            txs += [b"bare%d" % h, b"fee:%d:pay" % (7 * h)]
            if h == 2:
                txs += [b"val:" + base64.b64encode(pks[3]) + b"!5",
                        b"val:" + base64.b64encode(pks[0]) + b"!0", b"val:!!notb64!x"]
            for tx in txs:
                out.append(await m.check_tx(abci.RequestCheckTx(tx=tx)))
            out.append(await c.begin_block(abci.RequestBeginBlock(
                hash=rng.bytes(32), byzantine_validators=[{"address": rng.bytes(20), "height": h}]
                if h == 3 else [])))
            for tx in txs:
                out.append(await c.deliver_tx(abci.RequestDeliverTx(tx=tx)))
            out.append(await c.end_block(abci.RequestEndBlock(height=h)))
            out.append(await c.commit())
        for data, path in ((b"k1-0", ""), (b"bare2", ""), (b"missing", ""), (pks[3], "/val"),
                           (pks[0], "/val"), (b"__byzantine__", "")):
            out.append(await q.query(abci.RequestQuery(data=data, path=path)))
        snaps = await q.list_snapshots(abci.RequestListSnapshots())
        out.append(snaps)
        # restore the newest snapshot into a fresh app, chunk by chunk
        snap = snaps.snapshots[-1]
        fresh = examples.KVStoreApplication(db=kvstore.MemDB())
        out.append(fresh.offer_snapshot(abci.RequestOfferSnapshot(snapshot=snap)))
        out.append(fresh.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=1, chunk=b"")))
        for i in range(snap.chunks):
            chunk = (await q.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(
                snap.height, snap.format, i))).chunk
            out.append(fresh.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(
                index=i, chunk=chunk, sender="peer")))
        out.append(fresh.info(abci.RequestInfo()))
        out.append(fresh.offer_snapshot(abci.RequestOfferSnapshot(
            snapshot=abci.Snapshot(snap.height, 9, 1, b"", b""))))
        # the app reopened on its store resumes where it stopped
        out.append(examples.KVStoreApplication(db=app.db).info(abci.RequestInfo()))
    finally:
        await conns.stop()
    return [dataclasses.asdict(r) if r is not None else None for r in out]


async def test_kvstore_app_over_app_conns_matches_jax():
    ours = await _kvstore_session("port")
    theirs = await _kvstore_session("jax")
    assert ours == theirs
    # the session reached what it was built for
    assert any(r.get("log") == "invalid validator tx" for r in ours if r)
    assert any(r.get("priority") == 14 for r in ours if r)
    # the restored app stands at the snapshot's height, the reopened one at 3
    assert ours[-3]["last_block_height"] == 2 and ours[-1]["last_block_height"] == 3


async def _counter_session(pkg, serial):
    abci, client, examples, proxy, kvstore = PKGS[pkg]
    creator = proxy.default_client_creator("counter_serial" if serial else "counter")
    conns = proxy.AppConns(creator)
    await conns.start()
    out = []
    try:
        c, m, q = conns.consensus(), conns.mempool(), conns.query()
        out.append(await q.set_option(abci.RequestSetOption("serial", "on" if serial else "off")))
        for nonce in (0, 1, 1, 5, 2, 9 ** 10):
            out.append(await m.check_tx(abci.RequestCheckTx(tx=nonce.to_bytes(8, "big")
                                                             if nonce < 1 << 64 else b"x" * 9)))
        for nonce in (0, 1, 3, 2):
            out.append(await c.deliver_tx(abci.RequestDeliverTx(tx=nonce.to_bytes(2, "big"))))
        out.append(await c.commit())
        for path in ("tx", "hash", "other"):
            out.append(await q.query(abci.RequestQuery(path=path)))
        out.append(await q.info(abci.RequestInfo()))
    finally:
        await conns.stop()
    return [dataclasses.asdict(r) for r in out]


@pytest.mark.parametrize("serial", [True, False])
async def test_counter_app_matches_jax(serial):
    ours, theirs = await _counter_session("port", serial), await _counter_session("jax", serial)
    assert ours == theirs
    assert any(r.get("code") == 2 for r in ours) == serial


async def test_local_clients_share_one_lock_and_noop_app():
    """AppConns' three LocalClients of one local creator share its lock
    (the reference's one mutex), and the noop app answers defaults."""
    conns = pproxy.AppConns(pproxy.default_client_creator("noop"))
    await conns.start()
    try:
        c, m, q = conns.consensus(), conns.mempool(), conns.query()
        assert c._lock is m._lock is q._lock
        assert isinstance(c.app, pabci.BaseApplication)
        assert await c.flush() is None
        res = await m.check_tx(pabci.RequestCheckTx(tx=b"x"))
        assert res == pabci.ResponseCheckTx()
        assert (await q.echo("hello")).message == "hello"
        assert await c.commit() == pabci.ResponseCommit()
        assert all(x.is_running for x in (c, m, q))
    finally:
        await conns.stop()
    assert not any(x.is_running for x in (c, m, q))


def test_client_creators_not_ported_raise():
    # bank and staking are builtin local apps, as in the JAX package: one
    # app behind every connection, on the app db when one is given
    for proxy, client_mod in ((pproxy, pclient), (jproxy, jclient)):
        for name, cls in (("bank", "BankApplication"), ("staking", "StakingApplication")):
            db = pkvstore.MemDB() if proxy is pproxy else jkvstore.MemDB()
            creator = proxy.default_client_creator(name, app_db=db)
            client = creator()
            assert isinstance(client, client_mod.LocalClient)
            assert type(client.app).__name__ == cls and client.app.db is db
            assert creator().app is client.app and creator()._lock is client._lock
    # abci = "grpc" gives a gRPC client per connection, as in the JAX package
    import tendermint_tpu.abci.grpc as jgrpc
    from tendermint_tpu_torch.abci import grpc as pgrpc

    for proxy, grpc_mod in ((pproxy, pgrpc), (jproxy, jgrpc)):
        creator = proxy.default_client_creator("tcp://127.0.0.1:26658", transport="grpc")
        client = creator()
        assert isinstance(client, grpc_mod.GRPCClient) and client is not creator()
    # a socket address gives a socket client per connection, as in the JAX
    # package
    for proxy, client_mod in ((pproxy, pclient), (jproxy, jclient)):
        creator = proxy.default_client_creator("tcp://127.0.0.1:26658")
        client = creator()
        assert isinstance(client, client_mod.SocketClient) and client is not creator()
        assert client.address == "tcp://127.0.0.1:26658"


def test_port_abci_imports_neither_msgpack_nor_jax():
    code = ("import sys; import tendermint_tpu_torch.proxy, tendermint_tpu_torch.mempool, "
            "tendermint_tpu_torch.consensus, tendermint_tpu_torch.state.execution, "
            "tendermint_tpu_torch.state.txindex, tendermint_tpu_torch.evidence; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('msgpack', 'jax', "
            "'tendermint_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_phase8_abci_end_to_end_on_cpu(monkeypatch):
    """chip_smoke.py phase 8 at 7 validators, 2 rotated by val: txs at
    height 4: the producer's 7 blocks through the mempool's signed-tx lane
    and BlockExecutor, the syncer's 6, and the three handshakes, all checked
    inside the phase."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "ABCI_TXS", 10)
    monkeypatch.setattr(cs, "ABCI_CORRUPT", 5)
    monkeypatch.setattr(cs, "ABCI_ROTATE", 2)
    launches = cs.phase_abci(cs.make_keys(7), "cpu", torch.device("cpu"))
    assert set(launches) == {"a", "flushes", "b", "c3"}
    assert batch_hook.get_indexed_verifier() is None
