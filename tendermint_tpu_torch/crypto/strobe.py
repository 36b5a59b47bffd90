"""STROBE-128 + Merlin transcripts — the sr25519 hashing substrate (the
port's copy of tendermint_tpu/crypto/strobe.py).

Reference parity: the reference's sr25519 (crypto/sr25519/pubkey.go:35)
delegates to go-schnorrkel, which hashes everything through Merlin
transcripts (mimoo/StrobeGo + gtank/merlin).  This is a from-scratch
implementation of the subset Merlin uses: Keccak-f[1600], STROBE-128
AD/META-AD/PRF/KEY operations, and the Merlin framing
(append_message/challenge_bytes), per the public STROBE v1.0.2 and Merlin
specifications.
"""

from __future__ import annotations

# -- Keccak-f[1600] ---------------------------------------------------------

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

_ROTC = (1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44)
_PILN = (10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1)
_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of the 200-byte state."""
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20] for x in range(5)]
        for x in range(5):
            d = c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1)
            for y in range(0, 25, 5):
                lanes[x + y] ^= d
        # rho + pi
        t = lanes[1]
        for i in range(24):
            j = _PILN[i]
            lanes[j], t = _rotl(t, _ROTC[i]), lanes[j]
        # chi
        for y in range(0, 25, 5):
            row = lanes[y : y + 5]
            for x in range(5):
                lanes[y + x] = row[x] ^ ((~row[(x + 1) % 5]) & row[(x + 2) % 5] & _MASK)
        # iota
        lanes[0] ^= rc
    for i in range(25):
        state[8 * i : 8 * i + 8] = lanes[i].to_bytes(8, "little")


# -- STROBE-128 -------------------------------------------------------------

_R = 166  # STROBE-128 rate: 200 - 2*(128/8) - 2

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    """The Merlin subset of STROBE-128 (no transport ops)."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 12 * 8])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # internal duplex calls
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] ^= b
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] = b
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError(
                    f"continuation flags {flags:#x} != begun {self.cur_flags:#x}"
                )
            return
        if flags & FLAG_T:
            raise ValueError("transport operations unsupported (Merlin subset)")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    # public ops
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        c = object.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c


# -- Merlin -----------------------------------------------------------------


class Transcript:
    """Merlin transcript (merlin::Transcript)."""

    def __init__(self, label: bytes, _strobe: Strobe128 | None = None):
        if _strobe is not None:
            self.strobe = _strobe
            return
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n)

    def clone(self) -> "Transcript":
        return Transcript(b"", _strobe=self.strobe.clone())
