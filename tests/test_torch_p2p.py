"""The port's p2p stack (tendermint_tpu_torch/p2p/, crypto/backend.py's
secret-connection primitives) against the JAX package's, tolerance 0.

- ChaCha20-Poly1305 on the port's C and pure tiers against the JAX
  package's (whose tier here is `cryptography`), byte for byte: RFC 8439
  §2.8.2, seeded random keys, nonces, AAD and lengths 0-3,000, tampered
  tags; X25519 on RFC 7748 §5.2 and §6.1; HKDF-SHA256 on RFC 5869 A.1-A.3.
- The wire: MConnection's packets for one sequence of sends, NodeInfo's
  dict and its msgpack bytes, a port SecretConnection against a JAX one
  over TCP in both directions, a port Switch against a JAX Switch on two
  channels.
- The JAX package's tests/test_p2p.py cases, run on the port.
- `check_ported`'s refusals of this slice and a p2p node it accepts.
"""

import asyncio
import os
import types

import msgpack
import numpy as np
import pytest

import tendermint_tpu.crypto.backend as jbackend
import tendermint_tpu.p2p as jp2p
import tendermint_tpu.p2p.conn.connection as jconnection
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.crypto import backend as pbackend
from tendermint_tpu_torch.crypto import hostprep
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding import msgpack as pmsgpack
from tendermint_tpu_torch.p2p import (
    ChannelDescriptor,
    NodeInfo,
    Reactor,
    SecretConnection,
    Switch,
    Transport,
)
from tendermint_tpu_torch.p2p.conn import connection as pconnection
from tendermint_tpu_torch.p2p.test_util import (
    connect_switches,
    make_connected_switches,
    make_switch,
    start_switch,
    stop_switches,
)

# -- the AEAD ------------------------------------------------------------------


def _seal_c(key, nonce, data, aad=b""):
    assert hostprep._load_lib() is not None
    return pbackend.chacha20poly1305_seal(key, nonce, data, aad)


def _open_c(key, nonce, sealed, aad=b""):
    assert hostprep._load_lib() is not None
    return pbackend.chacha20poly1305_open(key, nonce, sealed, aad)


TIERS = {
    "c": (_seal_c, _open_c),
    "pure": (pbackend._seal_pure, pbackend._open_pure),
}

RFC8439_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip "
              b"for the future, sunscreen would be it.")
RFC8439_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC8439_KEY = bytes(range(0x80, 0xA0))
RFC8439_NONCE = bytes.fromhex("070000004041424344454647")
RFC8439_CT_HEAD = bytes.fromhex("d31a8d34648e60db7b86afbc53ef7ec2")
RFC8439_TAG = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_aead_rfc8439_vector(tier):
    seal, open_ = TIERS[tier]
    sealed = seal(RFC8439_KEY, RFC8439_NONCE, RFC8439_PT, RFC8439_AAD)
    assert sealed[:16] == RFC8439_CT_HEAD and sealed[-16:] == RFC8439_TAG
    assert sealed == jbackend.chacha20poly1305_seal(RFC8439_KEY, RFC8439_NONCE, RFC8439_PT,
                                                    RFC8439_AAD)
    assert open_(RFC8439_KEY, RFC8439_NONCE, sealed, RFC8439_AAD) == RFC8439_PT


def _aead_cases(n=24):
    rng = np.random.default_rng(8439)
    lengths = [0, 1, 15, 16, 17, 63, 64, 65, 1022, 1024, 1040, 3000] + [
        int(x) for x in rng.integers(0, 3001, n - 12)]
    return [(rng.bytes(32), rng.bytes(12), rng.bytes(int(rng.integers(0, 40))), rng.bytes(ln))
            for ln in lengths]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_aead_matches_jax_on_seeded_inputs(tier):
    seal, open_ = TIERS[tier]
    for key, nonce, aad, data in _aead_cases():
        want = jbackend.chacha20poly1305_seal(key, nonce, data, aad)
        got = seal(key, nonce, data, aad)
        assert got == want, len(data)
        assert open_(key, nonce, got, aad) == data
        assert jbackend.chacha20poly1305_open(key, nonce, got, aad) == data


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_aead_tampered_tags_raise_as_jax_does(tier):
    seal, open_ = TIERS[tier]
    for key, nonce, aad, data in _aead_cases(14):
        sealed = bytearray(seal(key, nonce, data, aad))
        for pos in (len(sealed) - 1, len(sealed) - 16, 0):
            bad = bytearray(sealed)
            bad[pos] ^= 0x01
            with pytest.raises(pbackend.AEADError):
                open_(key, nonce, bytes(bad), aad)
            with pytest.raises(jbackend.AEADError):
                jbackend.chacha20poly1305_open(key, nonce, bytes(bad), aad)
        with pytest.raises(pbackend.AEADError):
            open_(key, nonce, bytes(sealed), aad + b"x")
    with pytest.raises(pbackend.AEADError):
        pbackend.chacha20poly1305_open(bytes(32), bytes(12), b"short")


# -- X25519 and HKDF -------------------------------------------------------------

RFC7748_52 = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]


@pytest.mark.parametrize("i", range(len(RFC7748_52)))
def test_x25519_rfc7748_vectors(i):
    k, u, out = RFC7748_52[i]
    k, u = bytes.fromhex(k), bytes.fromhex(u)
    got = pbackend.x25519_shared(k, u)
    assert got == jbackend.x25519_shared(k, u)
    assert got.hex() == out


def test_x25519_rfc7748_dh_and_generate():
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    b = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    shared = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    base = (9).to_bytes(32, "little")
    a_pub, b_pub = pbackend.x25519_shared(a, base), pbackend.x25519_shared(b, base)
    assert a_pub.hex() == "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    assert b_pub.hex() == "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    assert pbackend.x25519_shared(a, b_pub).hex() == shared
    assert pbackend.x25519_shared(b, a_pub).hex() == shared
    sk, pk = pbackend.x25519_generate()
    sk2, pk2 = jbackend.x25519_generate()
    assert pbackend.x25519_shared(sk, pk2) == jbackend.x25519_shared(sk2, pk)


RFC5869 = [  # (IKM, salt, info, L, OKM): A.1, A.2, A.3
    (bytes([0x0B] * 22), bytes(range(0x0D)), bytes(range(0xF0, 0xFA)), 42,
     "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf34007208d5b887185865"),
    (bytes(range(0x50)), bytes(range(0x60, 0xB0)), bytes(range(0xB0, 0x100)), 82,
     "b11e398dc80327a1c8e7f78c596a49344f012eda2d4efad8a050cc4c19afa97c59045a99cac7827271cb41c6"
     "5e590e09da3275600c2f09b8367793a9aca3db71cc30c58179ec3e87c14c01d5c1f3434f1d87"),
    (bytes([0x0B] * 22), b"", b"", 42,
     "8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d9d201395faa4b61a96c8"),
]


@pytest.mark.parametrize("case", ["A.1", "A.2", "A.3"])
def test_hkdf_rfc5869(case):
    ikm, salt, info, n, okm = RFC5869[["A.1", "A.2", "A.3"].index(case)]
    got = pbackend.hkdf_sha256(ikm, n, info, salt)
    assert got.hex() == okm
    assert got == jbackend.hkdf_sha256(ikm, n, info, salt)


# -- the wire ----------------------------------------------------------------------


class _CaptureConn:
    """What MConnection writes, one bytes object per packet."""

    def __init__(self):
        self.out = []
        self.closed = asyncio.Event()

    async def write_msg(self, data):
        self.out.append(bytes(data))

    async def read_msg(self, max_size=0):
        await self.closed.wait()
        raise ConnectionError("closed")

    def close(self):
        self.closed.set()


async def _packets(mod, sends):
    conn = _CaptureConn()
    descs = [mod.ChannelDescriptor(id=0x20, priority=5, send_queue_capacity=16),
             mod.ChannelDescriptor(id=0x21, priority=10, send_queue_capacity=16),
             mod.ChannelDescriptor(id=0x23, priority=1, send_queue_capacity=16)]

    async def on_receive(chan, msg):
        pass

    async def on_error(e):
        pass

    mc = mod.MConnection(conn, descs, on_receive, on_error)
    await mc.start()
    try:
        for chan, msg in sends:  # queued before the send routine first runs
            assert mc.try_send(chan, msg)
        for _ in range(2000):
            if not any(ch.is_send_pending() for ch in mc.channels.values()):
                break
            await asyncio.sleep(0.001)
        await asyncio.sleep(0.01)
        return conn.out
    finally:
        await mc.stop()


async def test_mconnection_packets_equal_jax():
    rng = np.random.default_rng(7)
    sends = [(0x20, rng.bytes(n)) for n in (0, 1, 1023, 1024, 1025)] + [
        (0x21, rng.bytes(5000)), (0x23, rng.bytes(3000)), (0x20, rng.bytes(2500)),
        (0x21, rng.bytes(64))]
    got = await _packets(pconnection, sends)
    want = await _packets(jconnection, sends)
    assert got == want
    assert len(got) == 18  # 1,024-byte payloads: 1+1+1+1+2 + 5 + 3 + 3 + 1
    # and the port's msgpack reads what it wrote as the `msgpack` package does
    for raw in got:
        assert pmsgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)


def test_node_info_dict_and_bytes_equal_jax():
    fields = dict(node_id="ab" * 20, listen_addr="127.0.0.1:26656", network="chain-x",
                  channels=bytes([0x40, 0x20, 0x21, 0x22, 0x23, 0x30, 0x38]), moniker="m",
                  gossip_version=3)
    p, j = NodeInfo(**fields), jp2p.NodeInfo(**fields)
    assert p.to_dict() == j.to_dict()
    assert pmsgpack.packb(p.to_dict()) == msgpack.packb(j.to_dict(), use_bin_type=True)
    assert NodeInfo.from_dict(dict(j.to_dict(), extra=1)) == p
    assert NodeInfo.from_dict({"node_id": "ab" * 20}).gossip_version == 0


async def _tcp_pair():
    accepted = asyncio.Queue()

    async def on_conn(r, w):
        await accepted.put((r, w))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    host, port = server.sockets[0].getsockname()[:2]
    client = await asyncio.open_connection(host, port)
    server_side = await accepted.get()
    server.close()
    return client, server_side


@pytest.mark.parametrize("port_side", ["dialer", "listener"])
async def test_secret_connection_against_jax(port_side):
    (cr, cw), (sr, sw) = await _tcp_pair()
    pk, jk = Ed25519PrivKey.generate(), JPrivKey.generate()
    if port_side == "dialer":
        pc, jc = await asyncio.gather(SecretConnection.make(cr, cw, pk),
                                      jp2p.SecretConnection.make(sr, sw, jk))
    else:
        jc, pc = await asyncio.gather(jp2p.SecretConnection.make(cr, cw, jk),
                                      SecretConnection.make(sr, sw, pk))
    try:
        assert pc.remote_pubkey.bytes() == jk.pub_key().bytes()
        assert jc.remote_pubkey.bytes() == pk.pub_key().bytes()
        big = os.urandom(100_000)
        await pc.write_msg(big)
        assert await jc.read_msg() == big
        await jc.write_msg(big[::-1])
        assert await pc.read_msg() == big[::-1]
    finally:
        pc.close()
        jc.close()


class EchoReactor(Reactor):
    CH = 0x77
    CHANNELS = (0x77, 0x78)

    def __init__(self):
        super().__init__("echo")
        self.received = []

    def get_channels(self):
        return [ChannelDescriptor(id=c, priority=1, send_queue_capacity=10) for c in self.CHANNELS]

    async def receive(self, chan_id, peer, msg):
        self.received.append((peer.id, chan_id, bytes(msg)))


class JEchoReactor(jp2p.Reactor):
    def __init__(self):
        super().__init__("echo")
        self.received = []

    def get_channels(self):
        return [jp2p.ChannelDescriptor(id=c, priority=1, send_queue_capacity=10)
                for c in EchoReactor.CHANNELS]

    async def receive(self, chan_id, peer, msg):
        self.received.append((peer.id, chan_id, bytes(msg)))


async def _until(cond, timeout=10.0):
    async def wait():
        while not cond():
            await asyncio.sleep(0.01)

    await asyncio.wait_for(wait(), timeout)


async def test_port_switch_and_jax_switch_exchange_on_two_channels():
    from tendermint_tpu.p2p.test_util import make_switch as jmake_switch
    from tendermint_tpu.p2p.test_util import start_switch as jstart_switch

    pr, jr = EchoReactor(), JEchoReactor()
    psw, jsw = make_switch(), jmake_switch()
    psw.add_reactor("echo", pr)
    jsw.add_reactor("echo", jr)
    await start_switch(psw)
    await jstart_switch(jsw)
    try:
        peer = await psw.dial_peer(f"{jsw.node_id}@{jsw.transport.listen_addr}")
        assert peer is not None
        await _until(lambda: psw.node_id in jsw.peers)
        big = os.urandom(50_000)
        await peer.send(0x77, b"port->jax on 0x77")
        await peer.send(0x78, big)
        await jsw.peers[psw.node_id].send(0x78, b"jax->port on 0x78")
        await jsw.peers[psw.node_id].send(0x77, big[::-1])
        await _until(lambda: len(pr.received) == 2 and len(jr.received) == 2)
        assert jr.received == [(psw.node_id, 0x77, b"port->jax on 0x77"),
                               (psw.node_id, 0x78, big)]
        assert pr.received == [(jsw.node_id, 0x78, b"jax->port on 0x78"),
                               (jsw.node_id, 0x77, big[::-1])]
    finally:
        await stop_switches([psw])
        await jsw.stop()


# -- tests/test_p2p.py's cases on the port ---------------------------------------


async def _secret_pair():
    (cr, cw), (sr, sw) = await _tcp_pair()
    k1, k2 = Ed25519PrivKey.generate(), Ed25519PrivKey.generate()
    c1, c2 = await asyncio.gather(SecretConnection.make(cr, cw, k1),
                                  SecretConnection.make(sr, sw, k2))
    return (c1, k1), (c2, k2), sr


async def test_secret_connection_handshake_and_roundtrip():
    (c1, k1), (c2, k2), _ = await _secret_pair()
    assert c1.remote_pubkey.bytes() == k2.pub_key().bytes()
    assert c2.remote_pubkey.bytes() == k1.pub_key().bytes()
    await c1.write_msg(b"hello across the wire")
    assert await c2.read_msg() == b"hello across the wire"
    big = bytes(range(256)) * 300
    await c2.write_msg(big)
    assert await c1.read_msg() == big
    c1.close()
    c2.close()


async def test_secret_connection_ciphertext_not_plaintext():
    (cr, cw), (sr, sw) = await _tcp_pair()
    k1, k2 = Ed25519PrivKey.generate(), Ed25519PrivKey.generate()
    c1, c2 = await asyncio.gather(SecretConnection.make(cr, cw, k1),
                                  SecretConnection.make(sr, sw, k2))
    secret = b"TOP-SECRET-PAYLOAD-1234567890"
    await c1.write_msg(secret)
    raw = await sr.readexactly(1024 + 16)
    assert secret not in raw
    c1.close()
    c2.close()


async def _two_switches(network2="test-net"):
    r1, r2 = EchoReactor(), EchoReactor()
    sw1, sw2 = make_switch(), make_switch(network=network2)
    sw1.add_reactor("echo", r1)
    sw2.add_reactor("echo", r2)
    await start_switch(sw1)
    await start_switch(sw2)
    return sw1, sw2, r1, r2


async def test_two_switches_exchange():
    sw1, sw2, r1, r2 = await _two_switches()
    try:
        await connect_switches(sw1, sw2)
        await sw1.peers[sw2.node_id].send(EchoReactor.CH, b"ping-1")
        await sw2.peers[sw1.node_id].send(EchoReactor.CH, b"pong-1")
        await _until(lambda: r1.received and r2.received)
        assert r2.received == [(sw1.node_id, EchoReactor.CH, b"ping-1")]
        assert r1.received == [(sw2.node_id, EchoReactor.CH, b"pong-1")]
    finally:
        await stop_switches([sw1, sw2])


async def test_large_message_multiplexed():
    sw1, sw2, r1, r2 = await _two_switches()
    try:
        await connect_switches(sw1, sw2)
        big = b"\xab" * 100_000  # spans ~100 packets
        small = b"between the packets"
        await sw1.peers[sw2.node_id].send(EchoReactor.CH, big)
        await sw1.peers[sw2.node_id].send(0x78, small)
        await _until(lambda: len(r2.received) == 2)
        assert sorted(r2.received) == sorted([(sw1.node_id, EchoReactor.CH, big),
                                              (sw1.node_id, 0x78, small)])
    finally:
        await stop_switches([sw1, sw2])


async def test_broadcast_mesh():
    reactors = {}

    def init(i, sw):
        reactors[i] = EchoReactor()
        sw.add_reactor("echo", reactors[i])

    switches = await make_connected_switches(4, init)
    try:
        assert all(sw.num_peers() == 3 for sw in switches)
        await switches[0].broadcast(EchoReactor.CH, b"to-all")
        await _until(lambda: all(reactors[i].received for i in (1, 2, 3)))
        for i in (1, 2, 3):
            assert reactors[i].received[0][2] == b"to-all"
        assert not reactors[0].received
    finally:
        await stop_switches(switches)


async def test_peer_disconnect_removes():
    sw1, sw2, _, _ = await _two_switches()
    try:
        await connect_switches(sw1, sw2)
        await sw1.stop_peer_for_error(sw1.peers[sw2.node_id], "test kick")
        assert sw2.node_id not in sw1.peers
        await _until(lambda: sw1.node_id not in sw2.peers)
    finally:
        await stop_switches([sw1, sw2])


async def test_network_mismatch_rejected():
    sw1, sw2, _, _ = await _two_switches(network2="chain-B")
    try:
        peer = await sw1.dial_peer(f"{sw2.node_id}@{sw2.transport.listen_addr}")
        assert peer is None
        assert sw1.num_peers() == 0
    finally:
        await stop_switches([sw1, sw2])


async def test_dial_wrong_id_rejected():
    sw1, sw2, _, _ = await _two_switches()
    try:
        peer = await sw1.dial_peer(f"{'ab' * 20}@{sw2.transport.listen_addr}")
        assert peer is None
    finally:
        await stop_switches([sw1, sw2])


async def test_stop_holds_id_and_blocks_readmission_until_teardown():
    calls = {"add": [], "remove": []}

    class Recording(EchoReactor):
        async def add_peer(self, peer):
            calls["add"].append(peer)

        async def remove_peer(self, peer, reason=None):
            calls["remove"].append(peer)

    sw1, sw2 = make_switch(), make_switch()
    sw1.add_reactor("echo", Recording())
    sw2.add_reactor("echo", EchoReactor())
    await start_switch(sw1)
    await start_switch(sw2)
    nk2 = sw2.transport.node_key
    sw3 = Switch(Transport(nk2, NodeInfo(node_id=nk2.id, network="test-net", moniker="twin")))
    sw3.add_reactor("echo", EchoReactor())
    await start_switch(sw3)
    try:
        await connect_switches(sw2, sw1)
        peer1 = sw1.peers[sw2.node_id]
        assert calls["add"] == [peer1]
        gate = asyncio.Event()
        orig_stop = peer1.stop

        async def slow_stop():
            await gate.wait()
            await orig_stop()

        peer1.stop = slow_stop
        kick = asyncio.ensure_future(sw1.stop_peer_for_error(peer1, "kick"))
        await asyncio.sleep(0.05)
        assert sw2.node_id in sw1._stopping and sw2.node_id not in sw1.peers
        await sw3.dial_peer(f"{sw1.node_id}@{sw1.transport.listen_addr}")
        await asyncio.sleep(0.05)
        assert sw2.node_id not in sw1.peers
        assert calls["add"] == [peer1], "no add during the stop window"
        gate.set()
        await kick
        assert calls["remove"] == [peer1]
        assert sw2.node_id not in sw1._stopping
        await connect_switches(sw3, sw1)
        assert len(calls["add"]) == 2
        assert calls["add"][1] is sw1.peers[sw2.node_id] and calls["add"][1] is not peer1
    finally:
        await stop_switches([sw1, sw2, sw3])


async def test_stale_peer_stop_never_touches_replacement_state():
    removed = []

    class Recording(EchoReactor):
        async def remove_peer(self, peer, reason=None):
            removed.append(peer)

    sw1, sw2 = make_switch(), make_switch()
    sw1.add_reactor("echo", Recording())
    sw2.add_reactor("echo", EchoReactor())
    await start_switch(sw1)
    await start_switch(sw2)
    try:
        await connect_switches(sw2, sw1)
        peer1 = sw1.peers[sw2.node_id]
        sentinel = object()
        sw1.peers[sw2.node_id] = sentinel
        await sw1.stop_peer_for_error(peer1, "stale kick")
        await asyncio.sleep(0.05)
        assert sw1.peers[sw2.node_id] is sentinel and removed == []
        await sw1.stop_peer_gracefully(peer1)
        assert sw1.peers[sw2.node_id] is sentinel and removed == []
        assert not peer1.is_running
    finally:
        del sw1.peers[sw2.node_id]
        await stop_switches([sw1, sw2])


# -- check_ported ------------------------------------------------------------------

# item None: lifted by the chaos rig (p2p/fuzz.py); check_ported passes it
P2P_UNPORTED = {
    "test_fuzz": (("p2p", "test_fuzz", True), None),
}


def _p2p_config(home):
    cfg = pconfig.test_config(home)
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.base.db_backend = "memdb"
    return cfg


@pytest.mark.parametrize("case", sorted(P2P_UNPORTED))
def test_check_ported_refuses_the_unported_p2p_parts(case, tmp_path):
    (section, field, value), item = P2P_UNPORTED[case]
    cfg = _p2p_config(str(tmp_path / "h"))
    pnode.check_ported(cfg)
    setattr(getattr(cfg, section), field, value)
    if item is None:
        pnode.check_ported(cfg)
        return
    with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {item}\); set "):
        pnode.check_ported(cfg)


def test_check_ported_accepts_statesync_and_the_default_rpc_laddr(tmp_path):
    """State sync and the RPC server are ported: the JAX defaults of
    `rpc.laddr` and `[statesync]` (enabled, with its trust servers) pass."""
    cfg = _p2p_config(str(tmp_path / "h"))
    cfg.rpc.laddr = pconfig.RPCConfig().laddr
    assert cfg.rpc.laddr == "tcp://127.0.0.1:26657"
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = "127.0.0.1:26657,127.0.0.1:26658"
    cfg.statesync.trust_height = 2
    cfg.statesync.trust_hash = "ab" * 32
    cfg.validate_basic()
    pnode.check_ported(cfg)


def test_check_ported_accepts_pex_and_seeds(tmp_path):
    """PEX and the address book are ported: the JAX default `pex = true`,
    a seed list and seed mode pass."""
    cfg = _p2p_config(str(tmp_path / "h"))
    cfg.p2p.pex = pconfig.P2PConfig().pex
    assert cfg.p2p.pex is True
    cfg.p2p.seeds = "ab@127.0.0.1:1,cd@127.0.0.1:2"
    cfg.p2p.seed_mode = True
    pnode.check_ported(cfg)


async def test_node_with_p2p_starts_and_registers_the_reactors(tmp_path):
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from tendermint_tpu_torch.types.priv_validator import MockPV

    pv = MockPV(Ed25519PrivKey(b"\x05" * 32))
    gen = GenesisDoc(chain_id="p2p-node", genesis_time_ns=1_700_000_000 * 10**9,
                     validators=[GenesisValidator(pv.address(), pv.get_pub_key(), 10)])
    cfg = _p2p_config(str(tmp_path / "h"))
    node = pnode.Node(cfg, gen, priv_validator=pv, db_backend="memdb")
    await node.start()
    try:
        assert node.switch.transport.listen_addr.startswith("127.0.0.1:")
        assert sorted(node.switch.reactors) == ["BLOCKCHAIN", "CONSENSUS", "EVIDENCE", "MEMPOOL",
                                                "STATESYNC"]
        assert node.switch.node_info.channels == bytes(
            [0x60, 0x61, 0x40, 0x20, 0x21, 0x22, 0x23, 0x30, 0x38])
        assert node.switch.node_info.gossip_version == 3
        assert node.switch.node_info.network == "p2p-node"
        # a solo validator skips fast sync: consensus runs at once
        assert not node.consensus_reactor.wait_sync and node.consensus.is_running
        await _until(lambda: node.block_store.height() >= 1)
    finally:
        await node.stop()
    assert not node.switch.is_running and not node.consensus.is_running
    # the JAX node advertises the STATESYNC channels too; one common
    # channel is enough for the handshake
    jinfo = jp2p.NodeInfo(node_id="cd" * 20, network="p2p-node",
                          channels=bytes([0x60, 0x61, 0x40, 0x20, 0x21, 0x22, 0x23, 0x30, 0x38]))
    node.switch.node_info.compatible_with(types.SimpleNamespace(**jinfo.to_dict()))
