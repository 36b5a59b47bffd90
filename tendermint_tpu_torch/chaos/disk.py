"""Disk-fault injection: the storage counterpart of link.py (the port's
copy of tendermint_tpu/chaos/disk.py).

The chaos engine could partition networks, skew clocks and double-sign —
but every scenario assumed the disk was perfect.  In production the disk
is the LEAST perfect component: ENOSPC under sustained ingress, EIO on a
dying volume, torn appends, fsyncs that lie, and silent bit-rot.  This
module makes the disk a first-class seeded fault domain:

  DiskPolicy       per-store fault probabilities (enospc / eio on write,
                   eio on fsync, torn appends, fsync-lie, read bit-flips)
  DiskFaultTable   one per node, keyed by store name ("blockstore",
                   "state", "app", "wal", "mempool-wal", "spool", or "*"),
                   mutated at runtime by the scenario DSL (`disk 2 enospc
                   @5`), the InProcRig or the `unsafe_chaos_disk` RPC
  FaultyDB         KVStore delegation wrapper — consults the table on
                   every write (raising honest OSErrors) and can flip a
                   byte on reads (TRANSIENT rot; the sealed block store
                   detects it and quarantines)
  FaultyGroup      autofile.Group delegation wrapper — torn appends cut a
                   record at a seeded byte offset before raising; a lying
                   fsync reports success without durability and tracks
                   the last genuinely-durable head offset so
                   `simulate_crash` can model the page-cache loss a power
                   cut would cause
  rot_block_store  PERSISTENT seeded bit-rot: flips a byte inside a
                   stored block-part entry, bypassing the wrappers — the
                   `rot N blockstore h=H` scenario action

Determinism: one RNG per (seed, store) drives every probability draw and
every flip/cut offset — same seed, same store, same operation order =>
byte-identical fault schedule, the chaos engine's replayability contract.
"""

from __future__ import annotations

import errno
import random
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from ..libs.log import get_logger

#: the store names a node registers (DSL and RPC validate against these)
STORES = ("blockstore", "state", "app", "wal", "mempool-wal", "spool")

#: fault kinds the DSL / RPC accept
FAULT_KINDS = ("enospc", "eio", "eio_fsync", "torn", "fsync_lie", "bitrot")


@dataclass(frozen=True)
class DiskPolicy:
    """Faults applied to one store.  The zero policy is a healthy disk."""

    enospc: float = 0.0  # P(a write raises ENOSPC)
    eio: float = 0.0  # P(a write raises EIO)
    eio_fsync: float = 0.0  # P(an fsync raises EIO)
    torn: float = 0.0  # P(an append is CUT at a seeded offset, then EIO)
    fsync_lie: bool = False  # fsync reports success without durability
    bitrot: float = 0.0  # P(a read returns one flipped byte)

    def is_healthy(self) -> bool:
        return (
            self.enospc <= 0.0
            and self.eio <= 0.0
            and self.eio_fsync <= 0.0
            and self.torn <= 0.0
            and not self.fsync_lie
            and self.bitrot <= 0.0
        )

    def to_dict(self) -> dict:
        return {
            "enospc": self.enospc,
            "eio": self.eio,
            "eio_fsync": self.eio_fsync,
            "torn": self.torn,
            "fsync_lie": self.fsync_lie,
            "bitrot": self.bitrot,
        }


HEALTHY = DiskPolicy()


def policy_for(kind: str, p: float = 1.0) -> DiskPolicy:
    """One-fault policy from a DSL/RPC (kind, probability) pair."""
    if kind == "enospc":
        return DiskPolicy(enospc=p)
    if kind == "eio":
        return DiskPolicy(eio=p)
    if kind == "eio_fsync":
        return DiskPolicy(eio_fsync=p)
    if kind == "torn":
        return DiskPolicy(torn=p)
    if kind == "fsync_lie":
        return DiskPolicy(fsync_lie=p > 0.0)
    if kind == "bitrot":
        return DiskPolicy(bitrot=p)
    raise ValueError(f"unknown disk fault kind {kind!r} (want one of {FAULT_KINDS})")


class DiskFaultTable:
    """All disk-fault state of one node, keyed by store name ("*" =
    every store).  Wrappers consult it at CALL time, so `set_policy` /
    `heal` take effect on the next IO without reopening anything."""

    WILDCARD = "*"

    def __init__(self, seed: int = 0, metrics=None, recorder=None):
        self.seed = seed
        self._policies: Dict[str, DiskPolicy] = {}
        self._rngs: Dict[str, random.Random] = {}
        self.metrics = metrics  # ChaosMetrics or None
        self.recorder = recorder  # FlightRecorder or None
        self.log = get_logger("chaos.disk")
        #: registered FaultyGroups (for simulate_crash page-cache loss)
        self._groups: List["FaultyGroup"] = []
        # injected-fault counters, per (store, kind)
        self.injected: Dict[Tuple[str, str], int] = {}

    # -- control (scenario orchestrator surface) ----------------------------

    def set_policy(self, store: str, policy: DiskPolicy) -> None:
        if store != self.WILDCARD and store not in STORES:
            raise ValueError(f"unknown store {store!r} (want one of {STORES} or '*')")
        if policy.is_healthy():
            self._policies.pop(store, None)
        else:
            self._policies[store] = policy
        if self.recorder is not None:
            self.recorder.record("chaos.disk", store=store, **_flat(policy.to_dict()))
        self.log.info("disk policy", store=store, **policy.to_dict())

    def heal(self, store: Optional[str] = None) -> None:
        if store is None or store == self.WILDCARD:
            self._policies.clear()
        else:
            self._policies.pop(store, None)
        if self.recorder is not None:
            self.recorder.record("chaos.disk_heal", store=store or "*")
        self.log.info("disk healed", store=store or "*")

    def policy(self, store: str) -> DiskPolicy:
        p = self._policies.get(store)
        if p is None:
            p = self._policies.get(self.WILDCARD)
        return p if p is not None else HEALTHY

    def policies(self) -> Dict[str, dict]:
        return {s: p.to_dict() for s, p in self._policies.items()}

    def counters(self) -> dict:
        return {f"{s}:{k}": n for (s, k), n in sorted(self.injected.items())}

    # -- injection decisions (wrapper surface) -------------------------------

    def _rng(self, store: str) -> random.Random:
        rng = self._rngs.get(store)
        if rng is None:
            rng = random.Random((self.seed * 1000003) ^ zlib.crc32(store.encode()))
            self._rngs[store] = rng
        return rng

    def _count(self, store: str, kind: str) -> None:
        self.injected[(store, kind)] = self.injected.get((store, kind), 0) + 1
        if self.metrics is not None and hasattr(self.metrics, "disk_faults"):
            self.metrics.disk_faults.labels(kind=kind).inc()
        if self.recorder is not None:
            self.recorder.record("chaos.disk_fault", store=store, fault=kind)

    def check_write(self, store: str, nbytes: int = 0) -> Optional[int]:
        """Consulted before a write.  Raises an honest OSError for
        ENOSPC/EIO; returns a CUT length (< nbytes) for a torn append the
        caller must apply before raising; returns None for a clean pass."""
        policy = self.policy(store)
        if policy.is_healthy():
            return None
        rng = self._rng(store)
        if policy.enospc > 0.0 and rng.random() < policy.enospc:
            self._count(store, "enospc")
            raise OSError(errno.ENOSPC, f"chaos: no space left on device ({store})")
        if policy.eio > 0.0 and rng.random() < policy.eio:
            self._count(store, "eio")
            raise OSError(errno.EIO, f"chaos: input/output error ({store})")
        if policy.torn > 0.0 and nbytes > 1 and rng.random() < policy.torn:
            self._count(store, "torn")
            return rng.randrange(1, nbytes)
        return None

    def check_fsync(self, store: str) -> bool:
        """Consulted before an fsync.  Raises EIO per policy; returns
        False when the fsync should LIE (report success, skip the real
        sync), True for a genuine sync."""
        policy = self.policy(store)
        if policy.eio_fsync > 0.0 and self._rng(store).random() < policy.eio_fsync:
            self._count(store, "eio_fsync")
            raise OSError(errno.EIO, f"chaos: fsync input/output error ({store})")
        if policy.fsync_lie:
            self._count(store, "fsync_lie")
            return False
        return True

    def mangle_read(self, store: str, value: Optional[bytes]) -> Optional[bytes]:
        """Read-side TRANSIENT bit-rot: per policy, return the value with
        one byte flipped at a seeded offset."""
        if value is None or len(value) == 0:
            return value
        policy = self.policy(store)
        if policy.bitrot <= 0.0:
            return value
        rng = self._rng(store)
        if rng.random() >= policy.bitrot:
            return value
        self._count(store, "bitrot")
        idx = rng.randrange(len(value))
        mutated = bytearray(value)
        mutated[idx] ^= 1 << rng.randrange(8)
        return bytes(mutated)

    # -- crash simulation ----------------------------------------------------

    def register_group(self, group: "FaultyGroup") -> None:
        self._groups.append(group)

    def simulate_crash(self) -> Dict[str, int]:
        """Model the power cut after lying fsyncs: truncate every
        registered group's head back to its last genuinely-durable
        offset (the OS page cache evaporating).  Returns
        {head_path: bytes_lost}."""
        lost = {}
        for g in self._groups:
            n = g.crash_truncate()
            if n:
                lost[g.head_path] = n
        return lost


def _flat(d: dict) -> dict:
    return {k: (int(v) if isinstance(v, bool) else v) for k, v in d.items()}


class FaultyDB:
    """KVStore delegation wrapper consulting a DiskFaultTable on every
    operation.  Write faults surface as honest OSErrors (exactly what a
    real dying volume raises through sqlite/the fs); read faults flip a
    byte in the RETURNED value only — the store's seal layer is what must
    catch them."""

    def __init__(self, inner, table: DiskFaultTable, store: str):
        self.inner = inner
        self.table = table
        self.store = store

    # -- reads ---------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        return self.table.mangle_read(self.store, self.inner.get(key))

    def has(self, key: bytes) -> bool:
        return self.inner.has(key)

    def iterate_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        for k, v in self.inner.iterate_prefix(prefix):
            yield k, self.table.mangle_read(self.store, v)

    # -- writes --------------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self.table.check_write(self.store, len(key) + len(value))
        self.inner.set(key, value)

    def delete(self, key: bytes) -> None:
        self.table.check_write(self.store, len(key))
        self.inner.delete(key)

    def write_batch(self, sets, deletes=()) -> None:
        staged = list(sets)
        staged_deletes = list(deletes)
        nbytes = sum(len(k) + len(v) for k, v in staged)
        self.table.check_write(self.store, nbytes)
        self.inner.write_batch(staged, staged_deletes)

    def close(self) -> None:
        self.inner.close()

    # storage_info reports per-store file usage through this
    @property
    def path(self):
        return getattr(self.inner, "path", None)


class FaultyGroup:
    """autofile.Group delegation wrapper.  Write faults: ENOSPC/EIO raise
    before any byte lands; a TORN append writes a seeded-length prefix and
    then raises (the on-disk record is genuinely cut — replay must cope).
    A lying fsync flushes to the OS but skips the real fsync and tracks
    the divergence for `simulate_crash`."""

    def __init__(self, inner, table: DiskFaultTable, store: str):
        self.inner = inner
        self.table = table
        self.store = store
        #: head offset known durable (last REAL fsync / open)
        self.durable_offset = inner.head_size()
        self.lied_syncs = 0
        table.register_group(self)

    # -- delegated surface ---------------------------------------------------
    @property
    def head_path(self) -> str:
        return self.inner.head_path

    def chunk_indices(self):
        return self.inner.chunk_indices()

    def write(self, data: bytes) -> None:
        cut = self.table.check_write(self.store, len(data))
        if cut is not None:
            self.inner.write(data[:cut])
            self.inner.flush()
            raise OSError(errno.EIO, f"chaos: torn append ({self.store}, {cut}/{len(data)}B)")
        self.inner.write(data)

    def append_record(self, payload: bytes) -> None:
        from ..libs.autofile import encode_frame

        self.write(encode_frame(payload))

    def read_records(self, *a, **kw):
        return self.inner.read_records(*a, **kw)

    def flush(self) -> None:
        self.inner.flush()

    def sync(self) -> None:
        if self.table.check_fsync(self.store):
            self.inner.sync()
            self.durable_offset = self.inner.head_size()
        else:
            self.inner.flush()  # data reaches the OS, never the platter
            self.lied_syncs += 1

    def maybe_rotate(self) -> None:
        self.inner.maybe_rotate()

    def _enforce_group_limit(self) -> None:
        # the flight spool enforces its size cap on every flush; the JAX
        # wrapper lacks this, so a chaos node's spool flush raises there
        # (ROADMAP 3.12, repaired in the port)
        self.inner._enforce_group_limit()

    def rotate(self) -> None:
        self.inner.rotate()
        self.durable_offset = 0

    def reader(self):
        return self.inner.reader()

    def read_all(self) -> bytes:
        return self.inner.read_all()

    def head_size(self) -> int:
        return self.inner.head_size()

    def read_head(self) -> bytes:
        return self.inner.read_head()

    def truncate_head(self, length: int) -> None:
        self.inner.truncate_head(length)
        self.durable_offset = min(self.durable_offset, length)

    def close(self) -> None:
        self.inner.close()

    # -- crash simulation ----------------------------------------------------
    def crash_truncate(self) -> int:
        """Drop head bytes past the last genuinely-durable offset — the
        page-cache loss a power cut inflicts after lying fsyncs.  Returns
        bytes lost.  (Close-and-reopen via raw file ops: the group's own
        handle may be positioned past the cut.)"""
        self.inner.flush()
        size = self.inner.head_size()
        if size <= self.durable_offset:
            return 0
        lost = size - self.durable_offset
        self.inner.truncate_head(self.durable_offset)
        return lost


# -- persistent bit-rot (the `rot` scenario action) --------------------------


def rot_block_store(block_store, height: int, seed: int = 0, part_index: int = 0) -> dict:
    """Flip ONE seeded byte inside the stored entry for block part
    (height, part_index), writing the damage back to the underlying DB —
    persistent, restart-surviving bit-rot, exactly what a failing platter
    leaves.  Bypasses FaultyDB wrappers (the damage is in the cells, not
    the bus).  Returns {key, offset, bit} for the log."""
    key = b"P:%d:%d" % (height, part_index)
    db = block_store.db
    inner = getattr(db, "inner", db)  # bypass read-mangle wrappers
    raw = inner.get(key)
    if raw is None:
        raise ValueError(f"no stored part at height {height} index {part_index}")
    rng = random.Random((seed * 7919) ^ height ^ (part_index << 16))
    # flip inside the sealed payload (past the 6-byte seal header when
    # present) so the damage models cell rot, not header damage — though
    # either is detected; header rot just classifies as "legacy undecodable"
    lo = 6 if len(raw) > 6 else 0
    offset = rng.randrange(lo, len(raw))
    bit = rng.randrange(8)
    mutated = bytearray(raw)
    mutated[offset] ^= 1 << bit
    inner.set(key, bytes(mutated))
    return {"key": key.decode(), "offset": offset, "bit": bit}
