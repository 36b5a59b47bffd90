"""Self-rotating append-only file group — the WAL substrate (the port's
copy of tendermint_tpu/libs/autofile.py).

Counterpart of the reference's `libs/autofile` (reference:
libs/autofile/group.go): an append-only head file plus rotated chunks
``<path>.000``, ``<path>.001``… rotated when the head exceeds
`head_size_limit`; total size bounded by `group_size_limit` by deleting the
oldest chunks.  Synchronous file IO.

Record framing (shared with consensus/wal.py): ``crc32(payload) u32 BE |
length u32 BE | payload``.  `walk_frames` is the ONE framing walker — it
serves replay decode, crash repair (torn-tail detection) and, with
``resync=True``, mid-file corruption recovery: the walker scans forward
for the next offset whose header + crc validate and reports the skipped
region instead of silently replaying garbage or refusing everything after
it.  A file written by either package reads back byte for byte in the
other.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

_FRAME = struct.Struct(">II")
#: default per-record bound for framed Group records (consensus/wal.py
#: passes its own MAX_RECORD_BYTES)
MAX_FRAME_BYTES = 10 * 1024 * 1024
#: bound on the forward scan a resync attempts past a corrupt region —
#: past this the file is declared corrupt-to-EOF rather than spending
#: O(n²) crc work on multi-megabyte garbage
MAX_RESYNC_SCAN = 4 * 1024 * 1024
#: bound on TOTAL crc bytes a single resync may hash: random garbage
#: produces plausible length fields at ~0.25% of offsets, and each one
#: would otherwise cost a multi-MB slice + crc — the chain prefilter
#: removes most, the budget hard-caps the rest
MAX_RESYNC_CRC_BYTES = 64 * 1024 * 1024

# terminal / region kinds yielded by walk_frames
TORN = "torn"  # incomplete header/payload at EOF (crash mid-write)
CORRUPT = "corrupt"  # bad crc / absurd length (NOT safely truncatable)
CLEAN = "clean"  # ends on a record boundary
SKIPPED = "skipped"  # resync-mode only: a corrupt region that was jumped


def fsync_dir(path: str) -> None:
    """fsync the DIRECTORY containing `path` — rename/replace atomicity
    alone does not survive power loss: the new directory entry may never
    reach the platter, losing the whole file.  POSIX requires a dir fsync
    to pin it (the reference's tempfile.WriteFileAtomic does the same).
    Best effort on platforms/filesystems that refuse directory fds."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def encode_frame(payload: bytes) -> bytes:
    return _FRAME.pack(zlib.crc32(payload) & 0xFFFFFFFF, len(payload)) + payload


def _frame_at(raw: bytes, pos: int, max_bytes: int) -> Optional[int]:
    """Length of a VALID frame starting at pos, else None (crc-checked)."""
    if len(raw) - pos < _FRAME.size:
        return None
    crc, length = _FRAME.unpack_from(raw, pos)
    if length > max_bytes or len(raw) - pos - _FRAME.size < length:
        return None
    data = raw[pos + _FRAME.size : pos + _FRAME.size + length]
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        return None
    return _FRAME.size + length


def _chain_plausible(raw: bytes, pos: int, length: int, max_bytes: int) -> bool:
    """O(1) prefilter before paying a crc over the candidate payload: the
    candidate frame must be followed by EOF, a torn header stub, or
    another plausible header — random garbage passes the length check at
    ~0.25% of offsets, and chaining drops that by another ~400x.  The
    cost: a genuine frame immediately followed by a SECOND corrupt region
    gets skipped (one extra record lost, resync continues at the next
    chained frame) — records are still never fabricated."""
    nxt = pos + _FRAME.size + length
    n = len(raw)
    if nxt > n - _FRAME.size:
        return True  # EOF or a torn header stub follows
    _, nlen = _FRAME.unpack_from(raw, nxt)
    # length bound only — no fits-the-remainder check, or a genuine frame
    # followed by a TORN record (plausible header, payload cut short)
    # would be skipped
    return nlen <= max_bytes


def find_next_frame(raw: bytes, start: int, max_bytes: int = MAX_FRAME_BYTES) -> Optional[int]:
    """Smallest offset >= start where a crc-valid frame begins (the resync
    primitive; a false positive needs a 32-bit crc collision).  Work is
    bounded: scan positions by MAX_RESYNC_SCAN, crc bytes by
    MAX_RESYNC_CRC_BYTES, with the chain prefilter gating which
    candidates pay a crc at all."""
    n = len(raw)
    stop = min(n, start + MAX_RESYNC_SCAN)
    crc_budget = MAX_RESYNC_CRC_BYTES
    for pos in range(start, stop):
        if n - pos < _FRAME.size:
            return None
        crc, length = _FRAME.unpack_from(raw, pos)
        if length > max_bytes or n - pos - _FRAME.size < length:
            continue
        if not _chain_plausible(raw, pos, length, max_bytes):
            continue
        if crc_budget - length < 0:
            return None  # budget exhausted: declare corrupt-to-EOF
        crc_budget -= length
        data = raw[pos + _FRAME.size : pos + _FRAME.size + length]
        if zlib.crc32(data) & 0xFFFFFFFF == crc:
            return pos
    return None


def walk_frames(
    raw: bytes, max_bytes: int = MAX_FRAME_BYTES, resync: bool = False
) -> Iterator[tuple]:
    """Yield ('record', offset, payload_bytes) for each whole record.

    Without resync (the historical contract, crash repair depends on it):
    exactly one terminal follows — (TORN, offset, detail) for an
    incomplete record at EOF, (CORRUPT, offset, detail) for a crc
    mismatch / absurd length, or (CLEAN, offset, '').

    With resync: a corrupt region is yielded as (SKIPPED, start, end) and
    the walk continues at `end` (the next crc-valid frame); the terminal
    is then only TORN or CLEAN.  A region with no later valid frame is
    yielded as (SKIPPED, start, n) followed by (CLEAN, n, '') — unless it
    parses as a torn tail (header sane, payload merely cut short), which
    stays TORN so tail repair still applies.
    """
    pos = 0
    n = len(raw)
    while pos < n:
        if n - pos < _FRAME.size:
            yield (TORN, pos, "torn header at EOF")
            return
        crc, length = _FRAME.unpack_from(raw, pos)
        if length > max_bytes:
            if not resync:
                yield (CORRUPT, pos, f"record length {length} exceeds max")
                return
            nxt = find_next_frame(raw, pos + 1, max_bytes)
            if nxt is None:
                yield (SKIPPED, pos, n)
                yield (CLEAN, n, "")
                return
            yield (SKIPPED, pos, nxt)
            pos = nxt
            continue
        if n - pos - _FRAME.size < length:
            # plausible header, payload cut short: a torn tail unless a
            # later valid frame proves the cut is mid-file corruption
            if resync:
                nxt = find_next_frame(raw, pos + 1, max_bytes)
                if nxt is not None:
                    yield (SKIPPED, pos, nxt)
                    pos = nxt
                    continue
            yield (TORN, pos, "torn payload at EOF")
            return
        data = raw[pos + _FRAME.size : pos + _FRAME.size + length]
        if zlib.crc32(data) & 0xFFFFFFFF != crc:
            if not resync:
                yield (CORRUPT, pos, f"crc mismatch at offset {pos}")
                return
            nxt = find_next_frame(raw, pos + 1, max_bytes)
            if nxt is None:
                yield (SKIPPED, pos, n)
                yield (CLEAN, n, "")
                return
            yield (SKIPPED, pos, nxt)
            pos = nxt
            continue
        yield ("record", pos, data)
        pos += _FRAME.size + length
    yield (CLEAN, pos, "")


def group_disk_stats(head_path: str) -> Optional[dict]:
    """On-disk shape of a group at `head_path` WITHOUT opening it for
    append (usable on a dead node's files): head size + rotated chunk
    count.  None when no head exists.  One implementation serves the live
    `storage_info` route and the offline debug-bundle storage section —
    two copies of the chunk-naming walk would drift."""
    if not os.path.exists(head_path):
        return None
    d = os.path.dirname(head_path) or "."
    base = os.path.basename(head_path)
    pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
    chunks = 0
    try:
        for name in os.listdir(d):
            if pat.match(name):
                chunks += 1
    except OSError:
        pass
    try:
        head_bytes = os.path.getsize(head_path)
    except OSError:
        head_bytes = 0
    return {"head_bytes": head_bytes, "chunks": chunks}


def dir_usage(path: str) -> dict:
    """Per-entry byte usage of a directory (one level of names, recursive
    sizes) — the debug-bundle / storage_info \"where did the disk go\"
    walk, shared between the live route and the offline debug bundle."""
    usage: dict = {}
    try:
        entries = sorted(os.listdir(path))
    except OSError:
        return usage
    for name in entries:
        p = os.path.join(path, name)
        try:
            if os.path.isfile(p):
                usage[name] = os.path.getsize(p)
            elif os.path.isdir(p):
                total = 0
                for root, _dirs, files in os.walk(p):
                    for f in files:
                        fp = os.path.join(root, f)
                        try:
                            total += os.path.getsize(fp)
                        except OSError:
                            continue
                usage[name] = total
        except OSError:
            continue
    return usage


class Group:
    def __init__(
        self,
        head_path: str,
        head_size_limit: int = 10 * 1024 * 1024,
        group_size_limit: int = 0,  # 0 = unlimited
    ):
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.group_size_limit = group_size_limit
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self._head = open(head_path, "ab")

    # -- index bookkeeping -------------------------------------------------
    def _chunk_path(self, idx: int) -> str:
        return f"{self.head_path}.{idx:03d}"

    def chunk_indices(self) -> list[int]:
        d = os.path.dirname(self.head_path) or "."
        base = os.path.basename(self.head_path)
        pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
        out = []
        for name in os.listdir(d):
            m = pat.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # -- writing ------------------------------------------------------------
    def write(self, data: bytes) -> None:
        self._head.write(data)

    def flush(self) -> None:
        self._head.flush()

    def sync(self) -> None:
        """flush + fsync — the WAL's WriteSync discipline
        (reference consensus/wal.go:201)."""
        self._head.flush()
        os.fsync(self._head.fileno())

    def maybe_rotate(self) -> None:
        if self._head.tell() < self.head_size_limit:
            return
        self.rotate()

    def rotate(self) -> None:
        self._head.close()
        indices = self.chunk_indices()
        nxt = (indices[-1] + 1) if indices else 0
        os.rename(self.head_path, self._chunk_path(nxt))
        # rename durability: without a directory fsync a power loss can
        # roll back the rename — or lose the chunk entirely
        fsync_dir(self.head_path)
        self._head = open(self.head_path, "ab")
        self._enforce_group_limit()

    def _enforce_group_limit(self) -> None:
        if self.group_size_limit <= 0:
            return
        while True:
            indices = self.chunk_indices()
            total = sum(os.path.getsize(self._chunk_path(i)) for i in indices)
            total += os.path.getsize(self.head_path)
            if total <= self.group_size_limit or not indices:
                return
            os.remove(self._chunk_path(indices[0]))

    # -- framed records ------------------------------------------------------
    def append_record(self, payload: bytes) -> None:
        """One crc-framed record (crc32|len|payload) — replay via
        read_records survives torn tails AND mid-file bit-rot."""
        self.write(encode_frame(payload))

    def read_records(
        self, max_bytes: int = MAX_FRAME_BYTES
    ) -> Tuple[List[bytes], dict]:
        """Replay every framed record oldest-chunk→head with resync over
        corrupt regions.  Returns (payloads, report) where report counts
        {'records', 'skipped_regions', 'skipped_bytes', 'torn'} — honest
        accounting of what the disk copy is missing."""
        raw = self.read_all()
        out: List[bytes] = []
        report = {"records": 0, "skipped_regions": 0, "skipped_bytes": 0, "torn": 0}
        for kind, pos, detail in walk_frames(raw, max_bytes, resync=True):
            if kind == "record":
                out.append(detail)
                report["records"] += 1
            elif kind == SKIPPED:
                report["skipped_regions"] += 1
                report["skipped_bytes"] += detail - pos
            elif kind == TORN:
                report["torn"] = 1
        return out, report

    # -- reading ------------------------------------------------------------
    def reader(self) -> Iterator[bytes]:
        """Yield raw byte chunks from oldest chunk through the head."""
        self._head.flush()
        for i in self.chunk_indices():
            with open(self._chunk_path(i), "rb") as f:
                yield f.read()
        with open(self.head_path, "rb") as f:
            yield f.read()

    def read_all(self) -> bytes:
        return b"".join(self.reader())

    def head_size(self) -> int:
        return self._head.tell()

    def read_head(self) -> bytes:
        self._head.flush()
        with open(self.head_path, "rb") as f:
            return f.read()

    def truncate_head(self, length: int) -> None:
        """Drop head-file bytes past `length` (torn-tail repair on reopen
        after a crash: a partial record must not corrupt later appends)."""
        self._head.flush()
        self._head.truncate(length)
        self._head.seek(length)
        os.fsync(self._head.fileno())

    def close(self) -> None:
        if not self._head.closed:
            self._head.flush()
            self._head.close()
