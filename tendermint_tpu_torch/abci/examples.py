"""Example ABCI apps: kvstore and counter — the framework's test fixtures
(the port's copy of tendermint_tpu/abci/examples.py).

Reference parity: abci/example/kvstore/kvstore.go (NewApplication:71,
tx format "key=value"), persistent_kvstore.go (validator-update txs
"val:<base64 pubkey>!<power>", InitChain, retain-height), and
abci/example/counter/counter.go (serial-nonce app).
"""

from __future__ import annotations

import base64
import hashlib
import struct
from typing import Dict, List, Optional

from ..encoding import codec
from ..libs.kvstore import KVStore, MemDB
from . import types as t

VALIDATOR_TX_PREFIX = b"val:"

# snapshot bookkeeping keys — excluded from snapshot payloads
_SNAP_META_PREFIX = b"__snapmeta__:"
_SNAP_CHUNK_PREFIX = b"__snapchunk__:"
SNAPSHOT_FORMAT = 1


def _k_snap_meta(height: int) -> bytes:
    return _SNAP_META_PREFIX + b"%016d" % height


def _k_snap_chunk(height: int, index: int) -> bytes:
    return _SNAP_CHUNK_PREFIX + b"%016d:%08d" % (height, index)


class KVStoreApplication(t.Application):
    """Merkle-less KV app.  Tx "key=value" sets key; bare "v" sets v=v.
    "val:<b64 pubkey>!<power>" updates the validator set (the mechanism the
    validator-change tests drive).  app_hash commits to (size, update
    count) deterministically.

    With `snapshot_interval` > 0 the app takes a state snapshot at every
    multiple of that height during `commit` (abci/example/kvstore
    PersistentKVStoreApplication snapshot flavor): the full key space is
    serialized, split into `snapshot_chunk_bytes` chunks addressed by
    SHA-256, and served via the four ABCI snapshot methods.  Snapshot
    metadata carries the chunk-hash list so both the statesync chunk
    scheduler and the restoring app verify every chunk by hash before it
    touches state."""

    def __init__(
        self,
        db: Optional[KVStore] = None,
        retain_blocks: int = 0,
        snapshot_interval: int = 0,
        snapshot_keep_recent: int = 2,
        snapshot_chunk_bytes: int = 65536,
    ):
        self.db = db or MemDB()
        self.retain_blocks = retain_blocks
        self.snapshot_interval = snapshot_interval
        self.snapshot_keep_recent = max(1, snapshot_keep_recent)
        self.snapshot_chunk_bytes = max(1, snapshot_chunk_bytes)
        self.height = 0
        self.app_hash = b""
        self.tx_count = 0
        self.validators: Dict[bytes, int] = {}  # pubkey -> power
        self._pending_updates: List[t.ValidatorUpdate] = []
        # in-flight restore: {"snapshot", "app_hash", "hashes", "buf", "next"}
        self._restore: Optional[dict] = None
        self._load_state()

    # -- state persistence -------------------------------------------------
    def _load_state(self) -> None:
        raw = self.db.get(b"__state__")
        if raw:
            height, tx_count, hash_len = struct.unpack("<QQB", raw[:17])
            self.height, self.tx_count = height, tx_count
            self.app_hash = raw[17 : 17 + hash_len]
        for k, v in self.db.iterate_prefix(b"__val__"):
            self.validators[k[len(b"__val__"):]] = struct.unpack("<q", v)[0]

    def _save_state(self) -> None:
        self.db.set(
            b"__state__",
            struct.pack("<QQB", self.height, self.tx_count, len(self.app_hash)) + self.app_hash,
        )

    # -- ABCI --------------------------------------------------------------
    def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return t.ResponseInfo(
            data="{\"size\":%d}" % self.tx_count,
            version="0.1.0",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        for vu in req.validators:
            self._set_validator(vu)
        return t.ResponseInitChain()

    def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        self._pending_updates = []
        if req.byzantine_validators:
            # Record evidence delivery in app state (deterministic: derived
            # from the committed block, identical on every node; excluded
            # from app_hash, which commits only to (tx_count, height)).
            # This is how the chaos checker PROVES the accountability
            # pipeline reached ABCI: query data=b"__byzantine__" returns
            # the hex addresses BeginBlock reported.
            key = b"kv:__byzantine__"
            existing = self.db.get(key)
            addrs = set(existing.split(b",")) if existing else set()
            for ev in req.byzantine_validators:
                addr = ev.get("address", b"") if isinstance(ev, dict) else b""
                if isinstance(addr, bytes) and addr:
                    addrs.add(addr.hex().encode())
            if addrs:
                self.db.set(key, b",".join(sorted(addrs)))
        return t.ResponseBeginBlock()

    def _is_validator_tx(self, tx: bytes) -> bool:
        return tx.startswith(VALIDATOR_TX_PREFIX)

    def _parse_validator_tx(self, tx: bytes) -> Optional[t.ValidatorUpdate]:
        try:
            body = tx[len(VALIDATOR_TX_PREFIX):]
            pk_b64, power = body.split(b"!", 1)
            return t.ValidatorUpdate(
                pub_key_type="ed25519", pub_key=base64.b64decode(pk_b64), power=int(power)
            )
        except Exception:
            return None

    def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        if self._is_validator_tx(req.tx) and self._parse_validator_tx(req.tx) is None:
            return t.ResponseCheckTx(code=1, log="invalid validator tx")
        # honor a fee:<n>: payload prefix as mempool priority (QoS demo:
        # the builtin app is what the load rigs drive)
        from ..mempool import tx_priority

        return t.ResponseCheckTx(
            code=t.CODE_TYPE_OK, gas_wanted=1, priority=tx_priority(req.tx)
        )

    def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        if self._is_validator_tx(req.tx):
            vu = self._parse_validator_tx(req.tx)
            if vu is None:
                return t.ResponseDeliverTx(code=1, log="invalid validator tx")
            self._set_validator(vu)
            self._pending_updates.append(vu)
            return t.ResponseDeliverTx(code=t.CODE_TYPE_OK)
        if b"=" in req.tx:
            key, value = req.tx.split(b"=", 1)
        else:
            key, value = req.tx, req.tx
        self.db.set(b"kv:" + key, value)
        self.tx_count += 1
        events = [
            t.Event(
                type="app",
                attributes=[
                    {"key": b"creator", "value": b"tendermint_tpu"},
                    {"key": b"key", "value": key},
                ],
            )
        ]
        return t.ResponseDeliverTx(code=t.CODE_TYPE_OK, events=events)

    def _set_validator(self, vu: t.ValidatorUpdate) -> None:
        if vu.power == 0:
            self.validators.pop(vu.pub_key, None)
            self.db.delete(b"__val__" + vu.pub_key)
        else:
            self.validators[vu.pub_key] = vu.power
            self.db.set(b"__val__" + vu.pub_key, struct.pack("<q", vu.power))

    def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        return t.ResponseEndBlock(validator_updates=list(self._pending_updates))

    def commit(self, req: t.RequestCommit = None) -> t.ResponseCommit:
        self.height += 1
        self.app_hash = hashlib.sha256(
            struct.pack("<QQ", self.tx_count, self.height)
        ).digest()
        self._save_state()
        if self.snapshot_interval > 0 and self.height % self.snapshot_interval == 0:
            self._take_snapshot()
        retain = 0
        if self.retain_blocks > 0 and self.height >= self.retain_blocks:
            retain = self.height - self.retain_blocks + 1
        return t.ResponseCommit(data=self.app_hash, retain_height=retain)

    # -- state-sync snapshots ----------------------------------------------

    def _snapshot_payload(self) -> bytes:
        """Deterministic serialization of the whole key space (sorted),
        excluding snapshot bookkeeping keys."""
        entries = sorted(
            (k, v)
            for k, v in self.db.iterate_prefix(b"")
            if not k.startswith(_SNAP_META_PREFIX) and not k.startswith(_SNAP_CHUNK_PREFIX)
        )
        return codec.dumps({"entries": entries})

    def _take_snapshot(self) -> None:
        payload = self._snapshot_payload()
        size = self.snapshot_chunk_bytes
        chunks = [payload[i : i + size] for i in range(0, len(payload), size)] or [b""]
        hashes = [hashlib.sha256(c).digest() for c in chunks]
        snap = t.Snapshot(
            height=self.height,
            format=SNAPSHOT_FORMAT,
            chunks=len(chunks),
            hash=hashlib.sha256(b"".join(hashes)).digest(),
            metadata=codec.dumps({"chunk_hashes": hashes}),
        )
        sets = [(_k_snap_meta(self.height), codec.dumps(vars(snap)))]
        sets += [(_k_snap_chunk(self.height, i), c) for i, c in enumerate(chunks)]
        self.db.write_batch(sets)
        # prune beyond keep_recent
        heights = sorted(self._snapshot_heights())
        for h in heights[: -self.snapshot_keep_recent]:
            meta = self._load_snapshot_meta(h)
            self.db.delete(_k_snap_meta(h))
            if meta is not None:
                for i in range(meta.chunks):
                    self.db.delete(_k_snap_chunk(h, i))

    def _snapshot_heights(self) -> List[int]:
        return [
            int(k[len(_SNAP_META_PREFIX):]) for k, _ in self.db.iterate_prefix(_SNAP_META_PREFIX)
        ]

    def _load_snapshot_meta(self, height: int) -> Optional[t.Snapshot]:
        raw = self.db.get(_k_snap_meta(height))
        return t.Snapshot(**codec.loads(raw)) if raw else None

    def list_snapshots(self, req: t.RequestListSnapshots) -> t.ResponseListSnapshots:
        snaps = [self._load_snapshot_meta(h) for h in sorted(self._snapshot_heights())]
        return t.ResponseListSnapshots(snapshots=[s for s in snaps if s is not None])

    def load_snapshot_chunk(self, req: t.RequestLoadSnapshotChunk) -> t.ResponseLoadSnapshotChunk:
        if req.format != SNAPSHOT_FORMAT:
            return t.ResponseLoadSnapshotChunk()
        chunk = self.db.get(_k_snap_chunk(req.height, req.chunk))
        return t.ResponseLoadSnapshotChunk(chunk=chunk or b"")

    def offer_snapshot(self, req: t.RequestOfferSnapshot) -> t.ResponseOfferSnapshot:
        snap = req.snapshot
        if snap is None or snap.chunks < 1 or snap.height < 1:
            return t.ResponseOfferSnapshot(result=t.OfferSnapshotResult.REJECT)
        if snap.format != SNAPSHOT_FORMAT:
            return t.ResponseOfferSnapshot(result=t.OfferSnapshotResult.REJECT_FORMAT)
        try:
            hashes = codec.loads(snap.metadata)["chunk_hashes"]
        except Exception:
            return t.ResponseOfferSnapshot(result=t.OfferSnapshotResult.REJECT)
        if (
            not isinstance(hashes, list)
            or len(hashes) != snap.chunks
            or any(not isinstance(h, bytes) or len(h) != 32 for h in hashes)
            or hashlib.sha256(b"".join(hashes)).digest() != snap.hash
        ):
            return t.ResponseOfferSnapshot(result=t.OfferSnapshotResult.REJECT)
        self._restore = {
            "snapshot": snap,
            "app_hash": req.app_hash,
            "hashes": hashes,
            "buf": [],
            "next": 0,
        }
        return t.ResponseOfferSnapshot(result=t.OfferSnapshotResult.ACCEPT)

    def apply_snapshot_chunk(self, req: t.RequestApplySnapshotChunk) -> t.ResponseApplySnapshotChunk:
        R = t.ApplySnapshotChunkResult
        if self._restore is None:
            return t.ResponseApplySnapshotChunk(result=R.ABORT)
        ctx = self._restore
        if req.index != ctx["next"]:
            # chunks apply strictly in order; out-of-order is a scheduler
            # bug or a replay — ask for the expected one again
            return t.ResponseApplySnapshotChunk(
                result=R.RETRY, refetch_chunks=[ctx["next"]]
            )
        if hashlib.sha256(req.chunk).digest() != ctx["hashes"][req.index]:
            # defense in depth: the syncer verifies hashes too, but a bad
            # chunk must never enter state even if it slips through
            return t.ResponseApplySnapshotChunk(
                result=R.RETRY,
                refetch_chunks=[req.index],
                reject_senders=[req.sender] if req.sender else [],
            )
        ctx["buf"].append(req.chunk)
        ctx["next"] += 1
        if ctx["next"] < ctx["snapshot"].chunks:
            return t.ResponseApplySnapshotChunk(result=R.ACCEPT)
        # final chunk: decode + replace state wholesale
        try:
            entries = codec.loads(b"".join(ctx["buf"]))["entries"]
        except Exception:
            self._restore = None
            return t.ResponseApplySnapshotChunk(result=R.REJECT_SNAPSHOT)
        for k, _ in list(self.db.iterate_prefix(b"kv:")):
            self.db.delete(k)
        for k, _ in list(self.db.iterate_prefix(b"__val__")):
            self.db.delete(k)
        for k, v in entries:
            self.db.set(k, v)
        self.validators = {}
        self._load_state()
        self._restore = None
        if self.height != ctx["snapshot"].height or (
            ctx["app_hash"] and self.app_hash != ctx["app_hash"]
        ):
            # restored state does not match the trusted header — poisoned
            # snapshot; wipe what we wrote and reject
            self.height, self.tx_count, self.app_hash = 0, 0, b""
            for k, _ in list(self.db.iterate_prefix(b"kv:")):
                self.db.delete(k)
            for k, _ in list(self.db.iterate_prefix(b"__val__")):
                self.db.delete(k)
            self.db.delete(b"__state__")
            self.validators = {}
            return t.ResponseApplySnapshotChunk(result=R.REJECT_SNAPSHOT)
        return t.ResponseApplySnapshotChunk(result=R.ACCEPT)

    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        if req.path == "/val":
            power = self.validators.get(req.data, 0)
            return t.ResponseQuery(code=t.CODE_TYPE_OK, value=struct.pack("<q", power))
        value = self.db.get(b"kv:" + req.data)
        if value is None:
            return t.ResponseQuery(code=t.CODE_TYPE_OK, key=req.data, log="does not exist")
        return t.ResponseQuery(code=t.CODE_TYPE_OK, key=req.data, value=value, log="exists", height=self.height)


class CounterApplication(t.Application):
    """Serial-nonce app (abci/example/counter): txs must be the big-endian
    encoding of the next count when serial mode is on."""

    def __init__(self, serial: bool = True):
        self.serial = serial
        self.tx_count = 0
        self.check_count = 0

    def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return t.ResponseInfo(data=f"{{\"hashes\":0,\"txs\":{self.tx_count}}}")

    def set_option(self, req: t.RequestSetOption) -> t.ResponseSetOption:
        if req.key == "serial":
            self.serial = req.value == "on"
        return t.ResponseSetOption()

    def _tx_value(self, tx: bytes) -> int:
        if len(tx) > 8:
            return -1
        return int.from_bytes(tx, "big")

    def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        if self.serial:
            v = self._tx_value(req.tx)
            if v < self.check_count:
                return t.ResponseCheckTx(
                    code=2, log=f"invalid nonce: got {v}, expected >= {self.check_count}"
                )
        self.check_count += 1
        return t.ResponseCheckTx(code=t.CODE_TYPE_OK)

    def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        if self.serial:
            v = self._tx_value(req.tx)
            if v != self.tx_count:
                return t.ResponseDeliverTx(
                    code=2, log=f"invalid nonce: got {v}, expected {self.tx_count}"
                )
        self.tx_count += 1
        return t.ResponseDeliverTx(code=t.CODE_TYPE_OK)

    def commit(self, req: t.RequestCommit = None) -> t.ResponseCommit:
        self.check_count = self.tx_count
        if self.tx_count == 0:
            return t.ResponseCommit(data=b"")
        return t.ResponseCommit(data=self.tx_count.to_bytes(8, "big"))

    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        if req.path == "tx":
            return t.ResponseQuery(value=str(self.tx_count).encode())
        if req.path == "hash":
            return t.ResponseQuery(value=str(self.tx_count).encode())
        return t.ResponseQuery(log=f"invalid query path: {req.path}")
