"""Remote signer: the privval socket boundary (the port's copy of
tendermint_tpu/privval/signer.py; its frames equal the JAX package's, so
either package's node takes the other's signer).

Reference parity: privval/signer_client.go:15 (SignerClient — the
PrivValidator the node uses), signer_listener_endpoint.go (node listens on
priv_validator_laddr, the signer dials IN), signer_dialer_endpoint.go +
signer_server.go (the external signer process wrapping a FilePV),
messages.go (SignVote/SignProposal/PubKey/Ping request-response pairs).

Wire: 4-byte big-endian length + msgpack codec frames (Vote/Proposal are
registered types).  The signer side is async end-to-end, so an in-process
signer (tests) shares the node's event loop without deadlock — the reason
ConsensusState awaits PrivValidator results via _maybe_await.

Transport security (privval/socket_listeners.go:80): tcp connections are
wrapped in SecretConnection (X25519 + ChaCha20-Poly1305, each side
authenticating with an ed25519 connection key), so the signing channel is
encrypted and tamper-proof on the wire; `unix://` sockets rely on
filesystem permissions, as in the reference.  On top of that the client
pins the VALIDATOR pubkey: a reconnecting signer must present the same
validator key or the new connection is rejected — an attacker who can
reach priv_validator_laddr cannot hijack the channel with a fake signer.

Randomness is explicit: each side's SecretConnection key is `conn_key=`
and the client's challenge nonces come from `nonce_fn=`, defaulting to the
JAX package's draws (Ed25519PrivKey.generate() per instance, os.urandom).
"""

from __future__ import annotations

import asyncio
import os
import struct
from typing import Callable, Optional, Tuple

from ..crypto.keys import Ed25519PrivKey, PubKey, pubkey_from_dict
from ..encoding import codec
from ..libs.log import get_logger
from ..libs.service import Service
from ..types.priv_validator import PrivValidator, challenge_sign_bytes
from ..types.proposal import Proposal
from ..types.vote import Vote


class RemoteSignerError(Exception):
    pass


def _split_addr(addr: str) -> Tuple[str, str, int]:
    """-> (scheme, host_or_path, port)."""
    scheme, sep, rest = addr.partition("://")
    if not sep:
        scheme, rest = "tcp", addr
    if scheme == "unix":
        return "unix", rest, 0
    host, _, port = rest.rpartition(":")
    return scheme, host or "127.0.0.1", int(port)


class _Chan:
    """Framed message channel; plaintext (unix) or SecretConnection (tcp)."""

    def __init__(self, reader, writer, secret_conn=None):
        self._reader = reader
        self._writer = writer
        self._sc = secret_conn

    @classmethod
    async def wrap(cls, reader, writer, scheme: str, conn_key: Ed25519PrivKey) -> "_Chan":
        if scheme == "unix":
            return cls(reader, writer)
        from ..p2p.conn.secret_connection import SecretConnection

        sc = await SecretConnection.make(reader, writer, conn_key)
        return cls(reader, writer, secret_conn=sc)

    async def send(self, msg: dict) -> None:
        payload = codec.dumps(msg)
        if self._sc is not None:
            await self._sc.write_msg(payload)
            return
        self._writer.write(struct.pack(">I", len(payload)) + payload)
        await self._writer.drain()

    async def recv(self) -> dict:
        if self._sc is not None:
            return codec.loads(await self._sc.read_msg(1 << 20))
        hdr = await self._reader.readexactly(4)
        (n,) = struct.unpack(">I", hdr)
        if n > 1 << 20:
            raise RemoteSignerError(f"oversized privval frame ({n} bytes)")
        return codec.loads(await self._reader.readexactly(n))

    def close(self) -> None:
        self._writer.close()


class SignerClient(PrivValidator, Service):
    """Node-side PrivValidator over the socket (privval/signer_client.go).

    Listens on `laddr`; a SignerServer dials in.  `start()` blocks until
    the signer connects and the pubkey is fetched (node startup needs it
    synchronously afterwards, node/node.go:612-618).
    """

    def __init__(
        self,
        laddr: str,
        timeout: float = 5.0,
        accept_timeout: float = 30.0,
        conn_key: Optional[Ed25519PrivKey] = None,
        nonce_fn: Optional[Callable[[int], bytes]] = None,
    ):
        Service.__init__(self, "signer-client")
        self.laddr = laddr
        self.timeout = timeout
        self.accept_timeout = accept_timeout
        self.log = get_logger("privval.client")
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn: Optional[_Chan] = None
        self._conn_ready = asyncio.Event()
        self._lock = asyncio.Lock()
        self._pub_key: Optional[PubKey] = None
        self.listen_addr: str = ""
        # fresh connection key per start, as the reference's tcp listener
        # (privval/socket_listeners.go NewTCPListener callers)
        self._conn_key = conn_key or Ed25519PrivKey.generate()
        self._nonce_fn = nonce_fn or os.urandom
        self._scheme = "tcp"

    async def on_start(self) -> None:
        self._scheme, host, port = _split_addr(self.laddr)
        if self._scheme == "unix":
            self._server = await asyncio.start_unix_server(self._on_accept, path=host)
            self.listen_addr = self.laddr
        else:
            self._server = await asyncio.start_server(self._on_accept, host, port)
            sock = self._server.sockets[0]
            self.listen_addr = "%s:%d" % sock.getsockname()[:2]
        try:
            await asyncio.wait_for(self._conn_ready.wait(), self.accept_timeout)
        except asyncio.TimeoutError:
            raise RemoteSignerError(f"no remote signer connected within {self.accept_timeout}s")
        self._pub_key = await self._fetch_pub_key()

    async def on_stop(self) -> None:
        if self._conn is not None:
            self._conn.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _on_accept(self, reader, writer) -> None:
        try:
            chan = await asyncio.wait_for(
                _Chan.wrap(reader, writer, self._scheme, self._conn_key), self.timeout
            )
        except Exception as e:
            self.log.error("signer handshake failed", err=repr(e))
            writer.close()
            return
        if self._pub_key is not None:
            # Reconnect: the new signer must PROVE possession of the SAME
            # validator key (a fresh-nonce challenge signature, verified
            # against the pinned pubkey) — merely stating the well-known
            # pubkey would let anyone reaching the laddr hijack signing.
            nonce = self._nonce_fn(32)
            try:
                await chan.send({"t": "challenge_req", "nonce": nonce})
                resp = await asyncio.wait_for(chan.recv(), self.timeout)
                sig = resp["sig"]
                ok = self._pub_key.verify(challenge_sign_bytes(nonce), sig)
            except Exception as e:
                self.log.error("reconnect challenge probe failed", err=repr(e))
                chan.close()
                return
            if not ok:
                self.log.error(
                    "reconnecting signer failed validator-key proof of possession; rejecting"
                )
                chan.close()
                return
        if self._conn is not None:  # accepted replacement: drop the old conn
            self._conn.close()
        self._conn = chan
        self._conn_ready.set()
        self.log.info("remote signer connected")

    async def _request(self, msg: dict) -> dict:
        async with self._lock:
            if self._conn is None:
                raise RemoteSignerError("no signer connection")
            conn = self._conn
            await conn.send(msg)
            # NOT asyncio.wait_for: on 3.10 a caller cancellation arriving
            # in the same loop tick as the reply is SWALLOWED by wait_for
            # (bpo-42130) — the consensus receive task then survives its
            # own cancel mid-sign and node stop wedges on it (observed
            # under suite load).  asyncio.wait never eats the caller's
            # CancelledError; the recv task is reaped on every exit path.
            recv_task = asyncio.ensure_future(conn.recv())
            try:
                done, _ = await asyncio.wait({recv_task}, timeout=self.timeout)
            except asyncio.CancelledError:
                recv_task.cancel()
                raise
            if not done:
                recv_task.cancel()
                raise RemoteSignerError(f"signer request timed out after {self.timeout}s")
            resp = recv_task.result()
        if resp.get("t") == "error":
            raise RemoteSignerError(resp.get("err", "unknown remote signer error"))
        return resp

    async def _fetch_pub_key(self) -> PubKey:
        resp = await self._request({"t": "pubkey_req"})
        return pubkey_from_dict(resp["pubkey"])

    async def ping(self) -> None:
        await self._request({"t": "ping"})

    # -- PrivValidator (async: ConsensusState awaits via _maybe_await) -----

    def get_pub_key(self) -> PubKey:
        if self._pub_key is None:
            raise RemoteSignerError("signer client not started")
        return self._pub_key

    def address(self) -> bytes:
        return self.get_pub_key().address()

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        resp = await self._request({"t": "sign_vote_req", "chain_id": chain_id, "vote": vote})
        signed: Vote = resp["vote"]
        vote.signature = signed.signature
        vote.timestamp_ns = signed.timestamp_ns  # timestamp-only re-sign case

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        resp = await self._request(
            {"t": "sign_proposal_req", "chain_id": chain_id, "proposal": proposal}
        )
        signed: Proposal = resp["proposal"]
        proposal.signature = signed.signature
        proposal.timestamp_ns = signed.timestamp_ns


class SignerServer(Service):
    """Signer-side: wraps a local PrivValidator (normally FilePV), dials
    the node, serves sign requests (privval/signer_server.go + dialer
    endpoint retry loop)."""

    def __init__(
        self,
        laddr: str,
        priv_validator: PrivValidator,
        retries: int = 10,
        retry_interval: float = 0.5,
        conn_key: Optional[Ed25519PrivKey] = None,
    ):
        super().__init__("signer-server")
        self.laddr = laddr
        self.pv = priv_validator
        self.retries = retries
        self.retry_interval = retry_interval
        self.log = get_logger("privval.server")
        self._task: Optional[asyncio.Task] = None
        self._chan: Optional[_Chan] = None
        self._conn_key = conn_key or Ed25519PrivKey.generate()

    async def on_start(self) -> None:
        scheme, host, port = _split_addr(self.laddr)
        last_err: Optional[Exception] = None
        for _ in range(self.retries):
            try:
                if scheme == "unix":
                    reader, writer = await asyncio.open_unix_connection(host)
                else:
                    reader, writer = await asyncio.open_connection(host, port)
                break
            except OSError as e:
                last_err = e
                await asyncio.sleep(self.retry_interval)
        else:
            raise RemoteSignerError(f"cannot dial {self.laddr}: {last_err}")
        self._chan = await _Chan.wrap(reader, writer, scheme, self._conn_key)
        self._task = asyncio.create_task(self._serve(self._chan))

    async def on_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._chan is not None:
            self._chan.close()

    async def _serve(self, chan: _Chan) -> None:
        while True:
            try:
                req = await chan.recv()
            except (asyncio.IncompleteReadError, ConnectionError):
                self.log.info("node connection closed")
                return
            try:
                resp = self._handle(req)
            except Exception as e:  # double-sign refusals travel as errors
                resp = {"t": "error", "err": str(e)}
            await chan.send(resp)

    def _handle(self, req: dict) -> dict:
        kind = req.get("t")
        if kind == "ping":
            return {"t": "pong"}
        if kind == "pubkey_req":
            return {"t": "pubkey_resp", "pubkey": self.pv.get_pub_key().to_dict()}
        if kind == "challenge_req":
            return {"t": "challenge_resp", "sig": self.pv.sign_challenge(req["nonce"])}
        if kind == "sign_vote_req":
            vote: Vote = req["vote"]
            self.pv.sign_vote(req["chain_id"], vote)
            return {"t": "signed_vote_resp", "vote": vote}
        if kind == "sign_proposal_req":
            proposal: Proposal = req["proposal"]
            self.pv.sign_proposal(req["chain_id"], proposal)
            return {"t": "signed_proposal_resp", "proposal": proposal}
        raise RemoteSignerError(f"unknown privval request {kind!r}")
