"""SecretConnection: authenticated encryption over a raw stream (the port's
copy of tendermint_tpu/p2p/conn/secret_connection.py; its bytes on the wire
equal the JAX package's, so the two packages' nodes handshake).

Reference parity: p2p/conn/secret_connection.go (MakeSecretConnection:87,
Station-to-Station pattern): X25519 ephemeral DH → HKDF-SHA256 key
derivation (key order decided by sorting the ephemeral pubkeys) →
ChaCha20-Poly1305 AEAD over fixed 1024-byte frames with little-endian
counter nonces → ed25519 identity-key signature exchange over the
transcript challenge (authSigMessage :389).

Frame layout: 2-byte LE payload length + payload, zero-padded to
DATA_MAX_SIZE, sealed per-frame (sealedFrameSize on the wire).
"""

from __future__ import annotations

import asyncio
import struct
from typing import Tuple

from ...crypto import backend
from ...crypto.keys import Ed25519PrivKey, Ed25519PubKey

DATA_LEN_SIZE = 2
DATA_MAX_SIZE = 1022
TOTAL_FRAME_SIZE = 1024
AEAD_TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE


class SecretConnectionError(Exception):
    pass


def _derive_secrets(shared: bytes, loc_is_least: bool) -> Tuple[bytes, bytes, bytes]:
    """HKDF expand to (recv_key, send_key, challenge) from our perspective
    (secret_connection.go deriveSecretAndChallenge)."""
    okm = backend.hkdf_sha256(
        shared, 96, b"TENDERMINT_TPU_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"
    )
    if loc_is_least:
        recv_key, send_key = okm[0:32], okm[32:64]
    else:
        send_key, recv_key = okm[0:32], okm[32:64]
    challenge = okm[64:96]
    return recv_key, send_key, challenge


class _NonceCounter:
    """96-bit little-endian counter nonce (one per sealed frame)."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def next(self) -> bytes:
        nonce = struct.pack("<Q", self.n & ((1 << 64) - 1)) + struct.pack(
            "<I", self.n >> 64
        )
        self.n += 1
        return nonce


class SecretConnection:
    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        send_key: bytes,
        recv_key: bytes,
        remote_pubkey: Ed25519PubKey,
    ):
        self._reader = reader
        self._writer = writer
        self._send_key = send_key
        self._recv_key = recv_key
        self._send_nonce = _NonceCounter()
        self._recv_nonce = _NonceCounter()
        self.remote_pubkey = remote_pubkey
        self._recv_buf = b""
        self._write_lock = asyncio.Lock()
        self._read_lock = asyncio.Lock()

    # -- handshake ---------------------------------------------------------
    @classmethod
    async def make(
        cls,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        priv_key: Ed25519PrivKey,
    ) -> "SecretConnection":
        """secret_connection.go:87 MakeSecretConnection."""
        eph_priv, eph_pub = backend.x25519_generate()

        # 1. exchange ephemeral pubkeys (plaintext)
        writer.write(eph_pub)
        await writer.drain()
        remote_eph_pub = await reader.readexactly(32)

        # 2. shared secret + key derivation; key order by sorted eph keys
        shared = backend.x25519_shared(eph_priv, remote_eph_pub)
        loc_is_least = eph_pub < remote_eph_pub
        recv_key, send_key, challenge = _derive_secrets(shared, loc_is_least)

        conn = cls(reader, writer, send_key, recv_key, remote_pubkey=None)

        # 3. exchange identities: sign the challenge, send (pubkey, sig)
        #    through the now-encrypted channel (authSigMessage :389)
        sig = priv_key.sign(challenge)
        await conn.write_msg(priv_key.pub_key().bytes() + sig)
        auth = await conn.read_msg()
        if len(auth) != 32 + 64:
            raise SecretConnectionError("malformed auth message")
        remote_pub = Ed25519PubKey(auth[:32])
        if not remote_pub.verify(challenge, auth[32:]):
            raise SecretConnectionError("challenge verification failed")
        conn.remote_pubkey = remote_pub
        return conn

    # -- frame IO ----------------------------------------------------------
    async def write(self, data: bytes) -> None:
        """Encrypt data in DATA_MAX_SIZE frames."""
        async with self._write_lock:
            for off in range(0, len(data) or 1, DATA_MAX_SIZE):
                chunk = data[off : off + DATA_MAX_SIZE]
                frame = struct.pack("<H", len(chunk)) + chunk
                frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
                sealed = backend.chacha20poly1305_seal(
                    self._send_key, self._send_nonce.next(), frame
                )
                self._writer.write(sealed)
            await self._writer.drain()

    async def read(self, n: int) -> bytes:
        """Read exactly n plaintext bytes."""
        async with self._read_lock:
            while len(self._recv_buf) < n:
                sealed = await self._reader.readexactly(SEALED_FRAME_SIZE)
                try:
                    frame = backend.chacha20poly1305_open(
                        self._recv_key, self._recv_nonce.next(), sealed
                    )
                except Exception as e:
                    raise SecretConnectionError(f"frame decryption failed: {e}") from e
                (length,) = struct.unpack_from("<H", frame)
                if length > DATA_MAX_SIZE:
                    raise SecretConnectionError("invalid frame length")
                self._recv_buf += frame[DATA_LEN_SIZE : DATA_LEN_SIZE + length]
            out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
            return out

    # -- length-prefixed message helpers ----------------------------------
    async def write_msg(self, msg: bytes) -> None:
        await self.write(struct.pack("<I", len(msg)) + msg)

    async def read_msg(self, max_size: int = 64 * 1024 * 1024) -> bytes:
        raw = await self.read(4)
        (length,) = struct.unpack("<I", raw)
        if length > max_size:
            raise SecretConnectionError(f"message too large: {length}")
        return await self.read(length)

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass
