"""Mempool: priority-ordered tx pool with app-side validation, recheck and
the tx journal (the port's copy of tendermint_tpu/mempool.py).

Reference parity: mempool/clist_mempool.go (CheckTx:213, Update:529,
recheckTxs:591, ReapMaxBytesMaxGas:471, mapTxCache:641) + the
mempool/mempool.go interface.  The reference's concurrent linked list
becomes an insertion-ordered dict guarded by the event loop (single-task
mutation) plus an asyncio lock for the commit window.

QoS redesign (overload robustness; the v0.35 priority-mempool direction):
admission runs CHEAPEST-FIRST — structural size/envelope checks, then
dedup, then the full-pool decision — so garbage, duplicates and
would-be-rejected txs never buy a signature verify or an app round-trip
(the DoS lever of arXiv:2302.00418: unmetered signature work at ingress).
Storage is priority-ordered: `reap_max_bytes_max_gas` drains highest
priority first, and a full pool EVICTS its lowest-priority txs to admit a
better one instead of hard-rejecting it.  Priority comes from the app's
CheckTx response (`ResponseCheckTx.priority`) or a client-declared
``fee:<n>:`` payload prefix (`tx_priority`); default 0 preserves the
reference's FIFO behavior exactly.
"""

from __future__ import annotations

import asyncio
import collections
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .abci import types as abci
from .libs.log import get_logger
from .types.tx import tx_hash


class MempoolError(Exception):
    pass


# -- signed-tx envelope (mempool.sig_precheck) -------------------------------
#
# Optional ingress filter: ed25519-signed tx envelopes are batch-verified
# through the shared verify engine BEFORE the ABCI round-trip, so a burst
# of CheckTx calls coalesces into one device/host batch instead of the app
# paying per-tx signature checks (the committee-consensus scaling wall of
# arXiv:2302.00418, applied to mempool ingress).  Envelope layout:
#   SIGNED_TX_PREFIX ‖ pubkey(32) ‖ signature(64) ‖ payload
# with the signature over SIGNED_TX_DOMAIN ‖ payload.

SIGNED_TX_PREFIX = b"\x00sgtx1"
SIGNED_TX_DOMAIN = b"tendermint_tpu/signed-tx\x00"
_SIGNED_TX_HEADER = len(SIGNED_TX_PREFIX) + 32 + 64


def make_signed_tx(priv_key, payload: bytes) -> bytes:
    """Wrap a payload in a signed-tx envelope (test/client helper)."""
    sig = priv_key.sign(SIGNED_TX_DOMAIN + payload)
    return SIGNED_TX_PREFIX + priv_key.pub_key().bytes() + sig + payload


def parse_signed_tx(tx: bytes) -> Optional[tuple]:
    """(pubkey, sign_bytes, signature, payload) or None if not an
    envelope / malformed."""
    if not tx.startswith(SIGNED_TX_PREFIX) or len(tx) < _SIGNED_TX_HEADER:
        return None
    off = len(SIGNED_TX_PREFIX)
    pubkey = tx[off : off + 32]
    sig = tx[off + 32 : off + 96]
    payload = tx[_SIGNED_TX_HEADER:]
    return pubkey, SIGNED_TX_DOMAIN + payload, sig, payload


def tx_payload(tx: bytes) -> bytes:
    """The application payload: envelope stripped if present."""
    parsed = parse_signed_tx(tx)
    return parsed[3] if parsed is not None else tx


def tx_priority(tx: bytes) -> int:
    """Client-declared fee priority: a ``fee:<digits>:`` payload prefix
    (inside the signed envelope when there is one).  0 when absent — the
    structural parse is a few byte compares, cheap enough for the
    admission fast path."""
    payload = tx_payload(tx)
    if payload.startswith(b"fee:"):
        end = payload.find(b":", 4)
        if 4 < end <= 23:  # bounded digits: no big-int parse from the wire
            digits = payload[4:end]
            if digits.isdigit():
                return int(digits)
    return 0


class TxInCacheError(MempoolError):
    """mempool/errors.go ErrTxInCache."""

    def __init__(self):
        super().__init__("tx already exists in cache")


class MempoolFullError(MempoolError):
    def __init__(self, n_txs: int, total_bytes: int):
        super().__init__(f"mempool is full: {n_txs} txs, {total_bytes} bytes")


@dataclass
class MempoolTx:
    """mempool/clist_mempool.go:616 mempoolTx."""

    tx: bytes
    height: int  # height when validated
    gas_wanted: int
    senders: set  # peer ids that sent us this tx (mempoolIDs analogue)
    seq: int = 0  # monotone insertion sequence (clist-iteration analogue)
    priority: int = 0  # QoS rank: reap high-first, evict low-first


class TxCache:
    """LRU dedup cache (mapTxCache, clist_mempool.go:641)."""

    def __init__(self, size: int):
        self.size = size
        self._map: "collections.OrderedDict[bytes, None]" = collections.OrderedDict()

    def push(self, tx: bytes) -> bool:
        """False if already present."""
        key = tx_hash(tx)
        if key in self._map:
            self._map.move_to_end(key)
            return False
        if len(self._map) >= self.size:
            self._map.popitem(last=False)
        self._map[key] = None
        return True

    def contains(self, tx: bytes) -> bool:
        """Read-only membership (no LRU touch)."""
        return tx_hash(tx) in self._map

    def remove(self, tx: bytes) -> None:
        self._map.pop(tx_hash(tx), None)

    def reset(self) -> None:
        self._map.clear()


class Mempool:
    def __init__(
        self,
        proxy_app,  # abci Client (mempool connection)
        config=None,
        height: int = 0,
    ):
        cfg = config or {}
        self.proxy_app = proxy_app
        self.size_limit = cfg.get("size", 5000)
        self.max_txs_bytes = cfg.get("max_txs_bytes", 1024 * 1024 * 1024)
        self.max_tx_bytes = cfg.get("max_tx_bytes", 1024 * 1024)
        self.recheck = cfg.get("recheck", True)
        self.keep_invalid_txs_in_cache = cfg.get("keep_invalid_txs_in_cache", False)
        self.sig_precheck = cfg.get("sig_precheck", False)
        # AsyncBatchVerifier (or anything with verify_one) — the node wires
        # its shared engine in when sig_precheck is on; None falls back to
        # the serial host path per tx
        self.sig_verifier = None
        self.cache = TxCache(cfg.get("cache_size", 10000))
        self.height = height
        self.txs: "Dict[bytes, MempoolTx]" = {}  # insertion-ordered
        self.txs_bytes = 0
        self._lock = asyncio.Lock()
        self._seq = 0
        #: bumped on EVERY content mutation (add / commit-removal /
        #: eviction / recheck-drop / flush): an equal version proves a
        #: reap would return the same set — the consensus pipeline's
        #: speculative-proposal invalidation key
        self.version = 0
        self._tx_log: List[MempoolTx] = []  # append-only, ordered by seq
        self._new_tx_event = asyncio.Event()  # wakes broadcast routines
        self._tx_available: Optional[asyncio.Event] = None
        self.notified_txs_available = False
        self.pre_check: Optional[Callable[[bytes], Optional[str]]] = None
        self.post_check = None
        self.log = get_logger("mempool")
        from .libs.metrics import MempoolMetrics
        from .libs.tracing import NOP as _NOP_RECORDER

        self.metrics = MempoolMetrics()  # nop; node swaps in prometheus
        self.recorder = _NOP_RECORDER  # node swaps in its flight recorder
        self.wal_size_limit = cfg.get("wal_size_limit", 16 * 1024 * 1024)
        self._wal = None  # optional tx journal (clist_mempool.go InitWAL)
        #: node wires a libs.watchdog.StorageHealth (disk_fault alarm path)
        self.storage_health = None

    # -- WAL (clist_mempool.go:137) ----------------------------------------
    def init_wal(self, wal_dir: str, size_limit: Optional[int] = None) -> None:
        """Append every accepted tx to a size-capped rotating journal
        under `<wal_dir>/wal` — operator-grade record of what entered the
        mempool.  Records are crc-framed (libs/autofile frame format) so
        replay survives torn tails AND mid-file bit-rot; journals written
        by the old hex-line format still replay (see wal_txs).

        Rotation reuses the consensus WAL's substrate (libs/autofile.Group,
        the head-size-limit pattern): the head rotates into numbered
        chunks and the OLDEST chunks are deleted past `size_limit` total —
        under a sustained ingress firehose the journal is bounded instead
        of growing without limit."""
        import os

        from .libs.autofile import Group

        limit = self.wal_size_limit if size_limit is None else size_limit
        os.makedirs(wal_dir, exist_ok=True)
        self._wal = Group(
            os.path.join(wal_dir, "wal"),
            # several chunks inside the total bound so rotation sheds old
            # entries gradually, not half the journal at once
            head_size_limit=max(4096, limit // 8),
            group_size_limit=limit,
        )

    def close_wal(self) -> None:
        if self._wal is not None:
            try:
                self._wal.close()
            except OSError as e:  # a dying disk may refuse the close flush
                self.log.error("mempool wal close failed", err=str(e))
            self._wal = None

    def _wal_write(self, tx: bytes) -> None:
        if self._wal is not None:
            try:
                self._wal.append_record(tx)
                self._wal.flush()
                self._wal.maybe_rotate()
            except OSError as e:
                # tx journaling is best-effort by design (the reference
                # logs and keeps serving too) — but the fault must reach
                # the watchdog's disk_fault alarm, not just a log line
                self.log.error("mempool wal write failed", err=str(e))
                if self.storage_health is not None:
                    self.storage_health.note_write_error("mempool-wal", e)

    @staticmethod
    def _legacy_hex_lines(raw: bytes) -> List[bytes]:
        """Pre-CRC journal format: one hex line per tx; a torn tail line
        ends the replay cleanly."""
        out: List[bytes] = []
        for line in raw.splitlines():
            try:
                out.append(bytes.fromhex(line.decode()))
            except (ValueError, UnicodeDecodeError):
                break
        return out

    def wal_txs(self) -> List[bytes]:
        """Replay the retained journal (oldest chunk through head),
        resyncing past corrupt regions (crc framing).  Old-format journals
        (hex lines, pre-CRC) still replay: a file with no decodable frames
        falls back to hex-line parsing, and a legacy file APPENDED to by
        the framed writer recovers the legacy prefix from the skipped
        region the frame walker reports."""
        if self._wal is None:
            return []
        from .libs import autofile

        raw = self._wal.read_all()
        if not raw:
            return []
        out: List[bytes] = []
        skipped: List[bytes] = []
        frames = 0
        for kind, pos, detail in autofile.walk_frames(raw, resync=True):
            if kind == "record":
                out.append(detail)
                frames += 1
            elif kind == autofile.SKIPPED:
                skipped.append(raw[pos:detail])
        if frames == 0:
            # no framed records at all: a pure legacy journal
            return self._legacy_hex_lines(raw)
        if skipped:
            # mixed file (legacy prefix + framed appends after an upgrade):
            # recover hex lines from the skipped regions, oldest first
            legacy = [tx for region in skipped for tx in self._legacy_hex_lines(region)]
            out = legacy + out
            if self.storage_health is not None and not legacy:
                # skipped bytes that were NOT legacy lines = real rot
                self.storage_health.note_corruption(
                    "mempool-wal", f"{len(skipped)} corrupt region(s) skipped in replay"
                )
        return out

    # -- locking (commit window) ------------------------------------------
    def lock(self):
        return self._lock

    async def flush_app_conn(self) -> None:
        await self.proxy_app.flush()

    # -- tx availability signal (consensus WaitForTxs) ---------------------
    def enable_txs_available(self) -> None:
        self._tx_available = asyncio.Event()

    def txs_available(self) -> Optional[asyncio.Event]:
        return self._tx_available

    def _notify_txs_available(self) -> None:
        if not self.txs:
            raise RuntimeError("notified txs available but mempool is empty")
        if self._tx_available is not None and not self.notified_txs_available:
            self.notified_txs_available = True
            self._tx_available.set()

    # -- ingress -----------------------------------------------------------
    #
    # Admission pipeline, CHEAPEST FIRST (the QoS invariant: pre-rejected
    # garbage never buys a signature verify, let alone an app round-trip):
    #
    #   1. structural   size cap; envelope shape when sig_precheck is on
    #   2. dedup        cache hit rejects free (and records the sender)
    #   3. admission    full pool must be displaceable by this priority
    #   4. sig verify   batched through the shared engine
    #   5. app CheckTx  the ABCI round-trip
    #
    # Eviction (step 3 realized): a full pool throws out its LOWEST-
    # priority txs to admit a strictly better one — MempoolFullError is
    # reserved for txs that cannot displace anything.

    async def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        """CheckTx (clist_mempool.go:213): structural checks, cache-dedup,
        admission, sig precheck, app CheckTx, add.  Raises on rejection;
        returns the app response (which may itself carry a non-OK code)."""
        # 1. structural: a few byte compares before anything costs
        if len(tx) > self.max_tx_bytes:
            self.metrics.failed_txs.inc()
            raise MempoolError(f"tx too large: {len(tx)} > {self.max_tx_bytes}")
        envelope = None
        if self.sig_precheck and tx.startswith(SIGNED_TX_PREFIX):
            envelope = parse_signed_tx(tx)
            if envelope is None:
                # carries the prefix but is structurally broken: cache the
                # rejection — these exact bytes can never become valid, so
                # resubmission must stay free
                self.cache.push(tx)
                self.metrics.failed_txs.inc()
                raise MempoolError("malformed signed-tx envelope")
        # 2. dedup BEFORE any signature work: every gossiped duplicate
        # (and every resubmitted known-bad envelope) rejects here free
        if not self.cache.push(tx):
            # record the new sender for an existing tx (clist_mempool.go:239)
            existing = self.txs.get(tx_hash(tx))
            if existing is not None and sender:
                existing.senders.add(sender)
            raise TxInCacheError()
        priority = tx_priority(tx)
        try:
            if self.pre_check is not None:
                err = self.pre_check(tx)
                if err:
                    raise MempoolError(f"pre-check failed: {err}")
            # 3. admission: would this tx displace enough lower-priority
            # bytes?  Decided BEFORE the verify so a flood of low-priority
            # txs against a full pool never reaches the engine.
            self._admission_check(len(tx), priority)
        except MempoolError:
            # state-dependent rejection (pool may drain, params may
            # change): do NOT poison the cache for these bytes
            self.cache.remove(tx)
            self.metrics.failed_txs.inc()
            raise
        # 4. signature precheck, batched through the shared engine —
        # rejecting before the app round-trip is what lets a burst of
        # envelopes coalesce into one flush
        if envelope is not None:
            try:
                ok = await self._verify_tx_sig(envelope)
            except BaseException:
                # not judged: the same bytes must buy a verify when resubmitted
                self.cache.remove(tx)
                raise
            if not ok:
                # keep cached: the key is the hash of the FULL tx bytes
                # (pubkey+sig+payload), so these exact bytes can never
                # become valid — resubmission must not buy a fresh verify
                self.metrics.failed_txs.inc()
                raise MempoolError("invalid tx signature")

        # 5. the app round-trip
        res = await self.proxy_app.check_tx(abci.RequestCheckTx(tx=tx, type=abci.CheckTxType.NEW))
        if res.code == abci.CODE_TYPE_OK:
            # A NONZERO app priority overrides the fee-declared one; 0 is
            # indistinguishable from "app is priority-unaware" (the int
            # default), so the client fee survives it as a floor — an app
            # that wants to demote a tx outright rejects it (code != 0)
            priority = getattr(res, "priority", 0) or priority
            # re-run admission against the pool as it stands NOW (the
            # verify/app awaits may have admitted competitors), this time
            # actually evicting the displaced txs
            try:
                self._make_room(len(tx), priority)
            except MempoolFullError:
                self.cache.remove(tx)
                self.metrics.failed_txs.inc()
                raise
            self._seq += 1
            mtx = MempoolTx(
                tx=tx, height=self.height, gas_wanted=res.gas_wanted, senders=set(),
                seq=self._seq, priority=priority,
            )
            if sender:
                mtx.senders.add(sender)
            self.txs[tx_hash(tx)] = mtx
            self.txs_bytes += len(tx)
            self.version += 1
            self._tx_log.append(mtx)
            self._new_tx_event.set()
            self._wal_write(tx)
            self.log.debug("added good transaction", tx=tx_hash(tx).hex()[:16], res=res.code)
            self.metrics.size.set(len(self.txs))
            self.metrics.tx_size_bytes.observe(len(tx))
            self._notify_txs_available()
        else:
            if not self.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            self.metrics.failed_txs.inc()
            self.log.debug("rejected bad transaction", tx=tx_hash(tx).hex()[:16], code=res.code)
        return res

    def _is_full(self, tx_len: int) -> bool:
        return (
            len(self.txs) >= self.size_limit
            or self.txs_bytes + tx_len > self.max_txs_bytes
        )

    def _eviction_order(self) -> List[MempoolTx]:
        """Victims worst-first: lowest priority, then newest (an older tx
        of equal priority has waited longer and keeps its place)."""
        return sorted(self.txs.values(), key=lambda m: (m.priority, -m.seq))

    def _admission_check(self, tx_len: int, priority: int) -> None:
        """Raise MempoolFullError unless the pool has room or strictly
        lower-priority txs could be evicted to make it.  Read-only — the
        actual eviction happens in _make_room after the app accepts."""
        if not self._is_full(tx_len):
            return
        freeable = 0
        count = 0
        for mtx in self._eviction_order():
            if mtx.priority >= priority:
                break
            freeable += len(mtx.tx)
            count += 1
            if (
                len(self.txs) - count < self.size_limit
                and self.txs_bytes - freeable + tx_len <= self.max_txs_bytes
            ):
                return
        raise MempoolFullError(len(self.txs), self.txs_bytes)

    def _make_room(self, tx_len: int, priority: int) -> None:
        """Evict lowest-priority txs until the pool can hold `tx_len` more
        bytes + one more entry.  The eviction set is computed FIRST from
        one sorted walk (the _admission_check shape): when only equal-or-
        higher-priority txs stand in the way this raises MempoolFullError
        having evicted NOTHING — a rejection must never also drop valid
        txs the pool promised to keep."""
        if not self._is_full(tx_len):
            return
        victims: List[MempoolTx] = []
        freed = 0
        for mtx in self._eviction_order():
            if mtx.priority >= priority:
                raise MempoolFullError(len(self.txs), self.txs_bytes)
            victims.append(mtx)
            freed += len(mtx.tx)
            if (
                len(self.txs) - len(victims) < self.size_limit
                and self.txs_bytes - freed + tx_len <= self.max_txs_bytes
            ):
                break
        else:
            raise MempoolFullError(len(self.txs), self.txs_bytes)
        for victim in victims:
            self.txs.pop(tx_hash(victim.tx), None)
            self.txs_bytes -= len(victim.tx)
            self.version += 1
            # let the evicted tx re-enter later (it was valid, just outbid)
            self.cache.remove(victim.tx)
            self.metrics.priority_evicted.inc()
            self.metrics.priority_floor.set(victim.priority)
        if victims:
            self.recorder.record(
                "ingress.evict", n=len(victims), priority=priority, size=len(self.txs)
            )
            self.metrics.size.set(len(self.txs))
            self.log.debug(
                "evicted lower-priority txs", n=len(victims), for_priority=priority
            )

    async def _verify_tx_sig(self, parsed: tuple) -> bool:
        pubkey, sign_bytes, sig, _ = parsed
        if self.sig_verifier is not None:
            # Only a False verdict rejects.  An engine error (a kernel that
            # failed to build or launch) propagates: read as "invalid tx
            # signature" it would hide a broken device path.
            return bool(await self.sig_verifier.verify_one(pubkey, sign_bytes, sig))
        from .crypto import batch as batch_hook

        return bool(batch_hook.host_batch_verify([pubkey], [sign_bytes], [sig])[0])

    # -- egress ------------------------------------------------------------
    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        """clist_mempool.go:471, priority-ordered: the block drains the
        HIGHEST-priority txs first (ties broken by arrival seq, so an
        all-default-priority pool reaps in the reference's FIFO order)."""
        total_bytes = 0
        total_gas = 0
        out = []
        for mtx in sorted(self.txs.values(), key=lambda m: (-m.priority, m.seq)):
            nb = total_bytes + len(mtx.tx) + 8  # conservative framing overhead
            if max_bytes > -1 and nb > max_bytes:
                break
            ng = total_gas + mtx.gas_wanted
            if max_gas > -1 and ng > max_gas:
                break
            total_bytes = nb
            total_gas = ng
            out.append(mtx.tx)
        return out

    def reap_max_txs(self, n: int) -> List[bytes]:
        txs = [m.tx for m in self.txs.values()]
        return txs if n < 0 else txs[:n]

    def size(self) -> int:
        return len(self.txs)

    def is_empty(self) -> bool:
        return not self.txs

    # -- post-commit update ------------------------------------------------
    async def update(
        self,
        height: int,
        committed_txs: List[bytes],
        deliver_tx_responses: List[abci.ResponseDeliverTx],
        pre_check=None,
        post_check=None,
    ) -> None:
        """clist_mempool.go:529 — caller holds lock().  Removes committed
        txs, rechecks the remainder against the post-commit app state."""
        self.height = height
        self.notified_txs_available = False
        if self._tx_available is not None:
            self._tx_available.clear()
        if pre_check is not None:
            self.pre_check = pre_check
        if post_check is not None:
            self.post_check = post_check

        for tx, res in zip(committed_txs, deliver_tx_responses):
            if res.code == abci.CODE_TYPE_OK:
                self.cache.push(tx)  # committed: keep cached so it can't re-enter
            elif not self.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            mtx = self.txs.pop(tx_hash(tx), None)
            if mtx is not None:
                self.txs_bytes -= len(mtx.tx)
                self.version += 1

        if self.txs:
            if self.recheck:
                self.log.debug("recheck txs", num_txs=len(self.txs), height=height)
                self.metrics.recheck_times.inc()
                await self._recheck_txs()
            else:
                self._notify_txs_available()
        self.metrics.size.set(len(self.txs))

    async def _recheck_txs(self) -> None:
        """clist_mempool.go:591 — re-run CheckTx on survivors; drop newly
        invalid ones."""
        for key, mtx in list(self.txs.items()):
            res = await self.proxy_app.check_tx(
                abci.RequestCheckTx(tx=mtx.tx, type=abci.CheckTxType.RECHECK)
            )
            if res.code != abci.CODE_TYPE_OK:
                self.txs.pop(key, None)
                self.txs_bytes -= len(mtx.tx)
                self.version += 1
                if not self.keep_invalid_txs_in_cache:
                    self.cache.remove(mtx.tx)
        if self.txs:
            self._notify_txs_available()

    async def flush(self) -> None:
        """Remove all txs + reset cache (clist_mempool.go Flush)."""
        self.txs.clear()
        self.txs_bytes = 0
        self.version += 1
        self.cache.reset()

    # -- broadcast-routine support (mempool/reactor.go clist walk) ---------
    async def next_txs_after(self, seq: int) -> List[MempoolTx]:
        """Txs with insertion seq > given, waiting for new arrivals when
        drained — the waitable-iteration contract the reference gets from
        libs/clist.  O(new txs) via bisect over the append-only log, not a
        full-pool scan per wakeup per peer."""
        import bisect

        while True:
            start = bisect.bisect_right(self._tx_log, seq, key=lambda m: m.seq)
            out = [m for m in self._tx_log[start:] if tx_hash(m.tx) in self.txs]
            if out:
                return out
            # drop consumed prefix knowledge: compact when mostly stale
            if len(self._tx_log) > 2 * len(self.txs) + 64:
                self._tx_log = [m for m in self._tx_log if tx_hash(m.tx) in self.txs]
            self._new_tx_event.clear()
            await self._new_tx_event.wait()


class NopMempool:
    """mock/mempool.go — for non-validating components."""

    def lock(self):
        return asyncio.Lock()

    async def flush_app_conn(self):
        pass

    async def check_tx(self, tx, sender=""):
        raise MempoolError("nop mempool")

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return []

    def reap_max_txs(self, n):
        return []

    def size(self):
        return 0

    async def update(self, *a, **kw):
        pass

    def enable_txs_available(self):
        pass

    def txs_available(self):
        return None
