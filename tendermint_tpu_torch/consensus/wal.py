"""Consensus write-ahead log (the port's copy of
tendermint_tpu/consensus/wal.py; records go through the port's codec, so a
WAL file is byte-equal to the JAX package's for the same records).

Reference parity: consensus/wal.go (WAL iface:64, BaseWAL:82, Write:184,
WriteSync:201, SearchForEndHeight:231, WALEncoder.Encode:302 crc32+length
framing, WALDecoder:347, nilWAL:404).

Record framing: crc32(payload) u32 BE | length u32 BE | msgpack payload
(the shared libs/autofile frame).  Payload = {"type": "msg"|"timeout"|
"roundstate"|"endheight", "time_ns": int, ...}.  Every consensus input is
logged before processing; own messages fsync (WriteSync) so a crash can
never produce a double-sign after replay.

Corruption discipline: a torn TAIL record (crash mid-write) is truncated
on reopen; MID-FILE corruption (silent bit-rot) is detected by the crc —
`all_records()` stays loud (raises WALCorruptionError, the strict
contract fuzz tests pin), while the REPLAY paths (`replay_records`,
`search_for_end_height`) resync past the corrupt region, count what was
skipped, and keep every record the disk still faithfully holds, instead
of either crashing catchup or replaying garbage.
"""

from __future__ import annotations

import struct
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from ..encoding import codec
from ..libs import autofile
from ..libs.autofile import Group

_HEADER = struct.Struct(">II")
MAX_RECORD_BYTES = 10 * 1024 * 1024  # > max block part msg

# re-exported terminal kinds (one framing walker lives in libs/autofile —
# two copies of the subtle header/crc/advance logic would drift)
TORN = autofile.TORN  # incomplete header/payload at EOF (crash mid-write)
CORRUPT = autofile.CORRUPT  # bad crc / absurd length (NOT safely truncatable)
CLEAN = autofile.CLEAN  # ends on a record boundary
SKIPPED = autofile.SKIPPED  # resync mode: corrupt region jumped over


class WALCorruptionError(Exception):
    pass


def encode_record(payload: dict) -> bytes:
    data = codec.dumps(payload)
    return _HEADER.pack(zlib.crc32(data) & 0xFFFFFFFF, len(data)) + data


def walk_records(raw: bytes, resync: bool = False) -> Iterator[tuple]:
    """Yield ('record', offset, payload_bytes) for each whole record, then
    exactly one terminal (TORN|CORRUPT|CLEAN, offset, detail); with
    resync, corrupt regions become (SKIPPED, start, end) and the walk
    continues — see libs/autofile.walk_frames."""
    return autofile.walk_frames(raw, MAX_RECORD_BYTES, resync=resync)


def decode_records(raw: bytes) -> Iterator[dict]:
    """Yield records; raises WALCorruptionError on corruption; a truncated
    tail record (torn write at crash) ends iteration cleanly."""
    for kind, pos, data in walk_records(raw):
        if kind == "record":
            yield codec.loads(data)
        elif kind == CORRUPT:
            raise WALCorruptionError(data)
        else:  # TORN / CLEAN end iteration quietly
            return


def decode_records_resync(raw: bytes) -> Tuple[List[dict], dict]:
    """Tolerant decode: skip corrupt regions (bit-rot, multi-record torn
    spans) via crc resync and return (records, report) with
    {'skipped_regions', 'skipped_bytes', 'torn'} so the caller can log
    exactly what history was lost.  An undecodable payload INSIDE a
    crc-valid frame still raises — the crc matched, so that is a codec
    bug, not disk damage."""
    out: List[dict] = []
    report = {"records": 0, "skipped_regions": 0, "skipped_bytes": 0, "torn": 0}
    for kind, pos, detail in walk_records(raw, resync=True):
        if kind == "record":
            out.append(codec.loads(detail))
            report["records"] += 1
        elif kind == SKIPPED:
            report["skipped_regions"] += 1
            report["skipped_bytes"] += detail - pos
        elif kind == TORN:
            report["torn"] = 1
    return out, report


def torn_tail_offset(raw: bytes) -> Optional[int]:
    """Byte offset of a TORN tail record (incomplete header/payload at
    EOF — a crash mid-write), or None when the file ends on a record
    boundary or the problem is corruption (bad crc / absurd length),
    which must stay loud rather than be truncated away."""
    for kind, pos, _ in walk_records(raw):
        if kind == TORN:
            return pos
        if kind in (CORRUPT, CLEAN):
            return None
    return None


class WAL:
    def __init__(self, head_path: str, head_size_limit: int = 10 * 1024 * 1024):
        self.group = Group(head_path, head_size_limit=head_size_limit)
        self.flush_interval = 2.0
        self._last_flush = 0.0
        #: cumulative resync accounting from tolerant replays (observability:
        #: `storage_info` / debug bundles surface it)
        self.corrupt_regions_skipped = 0
        self.corrupt_bytes_skipped = 0
        # Crash repair: a torn tail record (power loss mid-write) would sit
        # between old and NEW appends and read as mid-file corruption later.
        # Truncate exactly the tear; genuine corruption is left in place to
        # fail loudly at replay (wal.go's decoder likewise skips only
        # EOF-truncated records).
        tear = torn_tail_offset(self.group.read_head())
        if tear is not None:
            self.group.truncate_head(tear)

    # -- writing -----------------------------------------------------------
    def write(self, payload: dict) -> None:
        """Buffered write (peer messages; wal.go:184)."""
        payload.setdefault("time_ns", time.time_ns())
        self.group.write(encode_record(payload))
        now = time.monotonic()
        if now - self._last_flush > self.flush_interval:
            self.group.flush()
            self._last_flush = now

    def write_sync(self, payload: dict) -> None:
        """fsync'd write (own messages + end-height; wal.go:201)."""
        payload.setdefault("time_ns", time.time_ns())
        self.group.write(encode_record(payload))
        self.group.sync()
        self.group.maybe_rotate()

    def flush_and_sync(self) -> None:
        self.group.sync()

    def write_end_height(self, height: int) -> None:
        self.write_sync({"type": "endheight", "height": height})

    # -- reading -----------------------------------------------------------
    def all_records(self) -> List[dict]:
        """STRICT decode — mid-file corruption raises (the fuzz-pinned
        contract: direct inspection must never silently drop history)."""
        return list(decode_records(self.group.read_all()))

    def replay_records(self) -> List[dict]:
        """Tolerant decode for the node's replay path: resync past
        corrupt regions rather than wedging the restart, accumulating the
        skip accounting on the WAL object."""
        records, report = decode_records_resync(self.group.read_all())
        self.corrupt_regions_skipped += report["skipped_regions"]
        self.corrupt_bytes_skipped += report["skipped_bytes"]
        return records

    def search_for_end_height(self, height: int) -> Tuple[Optional[List[dict]], bool]:
        """Records AFTER the EndHeight(height) marker, or (None, False)
        (wal.go:231).  height=0 accepts a fresh WAL (no marker needed).
        Uses the TOLERANT decode: catchup after a crash onto a bit-rotted
        WAL replays every surviving record instead of refusing to boot —
        skipped regions are counted on the WAL for the operator."""
        records = self.replay_records()
        if height == 0:
            # gr.CurHeight == 0 special case: start of WAL counts as marker
            found = True
            start = 0
            for i, rec in enumerate(records):
                if rec.get("type") == "endheight" and rec.get("height", -1) >= height:
                    start = i + 1
            return records[start:], found
        for i in range(len(records) - 1, -1, -1):
            rec = records[i]
            if rec.get("type") == "endheight" and rec.get("height") == height:
                return records[i + 1 :], True
        return None, False

    def close(self) -> None:
        self.group.close()


class NilWAL:
    """wal.go:404 — disabled WAL."""

    def write(self, payload: dict) -> None:
        pass

    def write_sync(self, payload: dict) -> None:
        pass

    def flush_and_sync(self) -> None:
        pass

    def write_end_height(self, height: int) -> None:
        pass

    def all_records(self):
        return []

    def replay_records(self):
        return []

    def search_for_end_height(self, height: int):
        return None, False

    def close(self) -> None:
        pass
