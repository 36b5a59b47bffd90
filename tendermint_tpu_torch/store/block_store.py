"""Block store: blocks persisted as merkle-proven parts + commits (the
port's copy of tendermint_tpu/store/block_store.py; the same keys, seals
and codec bytes, so either package reads the other's store).

Reference parity: store/store.go (BlockStore:33, SaveBlock:270,
LoadBlock:78, LoadBlockPart, LoadBlockMeta, LoadBlockCommit,
LoadSeenCommit, PruneBlocks:197).

Integrity (no reference counterpart — goleveldb CRCs its own blocks; our
sqlite/memdb backends do not): every entry written since this PR carries a
crc32 SEAL (magic | crc32(payload) | payload) checked on every load, so
silent bit-rot is DETECTED instead of served.  Legacy unsealed entries
still load (the seal is recognized by magic + crc; a legacy value that
fakes both needs a 32-bit collision behind the exact magic) and are
protected by the deeper check: `load_block` re-hashes the reassembled
block against the meta's block id.  A corrupt height is QUARANTINED —
persisted in-store so a restart remembers — which makes every load at
that height answer None (the node serves "don't have it", never garbage)
until `restore_block` refills it from a peer-fetched copy verified against
the expected hash.  `integrity_scan` is the boot-time / debug-triggered
sweep that turns latent rot into quarantine entries.
"""

from __future__ import annotations

import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional

from ..encoding import codec
from ..libs.kvstore import KVStore
from ..types.block import Block, BlockID, Commit, Header
from ..types.part_set import Part, PartSet


def _k_meta(height: int) -> bytes:
    return b"H:%d" % height


def _k_part(height: int, index: int) -> bytes:
    return b"P:%d:%d" % (height, index)


def _k_commit(height: int) -> bytes:
    return b"C:%d" % height


def _k_seen_commit(height: int) -> bytes:
    return b"SC:%d" % height


def _k_block_hash(h: bytes) -> bytes:
    return b"BH:" + h


_K_STATE = b"blockStore"
_K_QUARANTINE = b"blockStoreQuarantine"

# -- per-entry crc seal ------------------------------------------------------

_SEAL_MAGIC = b"\xc5\x1f"  # not a plausible msgpack/codec prefix
_SEAL = struct.Struct(">I")


def seal(payload: bytes) -> bytes:
    return _SEAL_MAGIC + _SEAL.pack(zlib.crc32(payload) & 0xFFFFFFFF) + payload


def unseal(value: Optional[bytes]):
    """-> (payload | None, corrupt: bool).  A value without the magic is a
    LEGACY entry (pre-seal format) and passes through; magic present with
    a crc mismatch is detected corruption."""
    if value is None:
        return None, False
    if len(value) >= 6 and value[:2] == _SEAL_MAGIC:
        payload = value[6:]
        if zlib.crc32(payload) & 0xFFFFFFFF == _SEAL.unpack_from(value, 2)[0]:
            return payload, False
        return None, True
    return value, False


class StoreCorruptionError(Exception):
    pass


@dataclass
class BlockMeta:
    """store/types.go BlockMeta: header + identity + sizes."""

    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def to_dict(self) -> dict:
        return {
            "block_id": self.block_id.to_dict(),
            "block_size": self.block_size,
            "header": self.header.to_dict(),
            "num_txs": self.num_txs,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BlockMeta":
        return cls(
            BlockID.from_dict(d["block_id"]), d["block_size"], Header.from_dict(d["header"]), d["num_txs"]
        )


codec.register("tm/BlockMeta")(BlockMeta)


class BlockStore:
    """Stores base..height contiguous blocks; prunes from the bottom on
    app-driven retain height (store/store.go:197)."""

    def __init__(self, db: KVStore):
        self.db = db
        self._mtx = threading.RLock()
        #: node wires a libs.watchdog.StorageHealth; corruption + quarantine
        #: events are reported through it (None = standalone store)
        self.storage_health = None
        #: node wires the blockchain reactor's refill kick: EVERY quarantine
        #: — boot scan, debug scan, or a read path tripping over rot mid-
        #: flight — queues the height for peer refill, not just the scans
        #: that happen to be followed by an explicit request_refill call
        self.on_quarantine = None
        self.last_scan: Optional[dict] = None
        state, corrupt = self._get(_K_STATE)
        if corrupt:
            # the 16-byte bookkeeping record itself rotted: refuse to guess
            # base/height — the operator (or the boot scan caller) must
            # decide, serving wrong heights is worse than not starting
            raise StoreCorruptionError("block store state record is corrupt")
        if state is not None:
            d = codec.loads(state)
            self._base, self._height = d["base"], d["height"]
        else:
            self._base, self._height = 0, 0
        q, corrupt = self._get(_K_QUARANTINE)
        if corrupt or q is None:
            self._quarantined = set()
            if corrupt:
                # a rotted quarantine record degrades to "nothing known
                # quarantined"; the next scan rebuilds it
                self._note_corruption("quarantine record corrupt")
        else:
            self._quarantined = set(codec.loads(q))

    # -- sealed db access ---------------------------------------------------
    def _get(self, key: bytes):
        """-> (payload | None, corrupt).  Decode failures downstream of a
        PASSING crc are codec bugs and stay loud; this layer only maps
        seal violations."""
        return unseal(self.db.get(key))

    def _load(self, key: bytes, height: Optional[int] = None):
        """Sealed get + codec decode; corruption (seal mismatch OR a
        legacy entry that no longer decodes) quarantines `height` when
        given and answers None — a corrupt entry is never served."""
        payload, corrupt = self._get(key)
        if corrupt:
            self._on_corrupt(key, height)
            return None
        if payload is None:
            return None
        try:
            return codec.loads(payload)
        except Exception:
            # legacy (unsealed) entry whose bytes rotted: undecodable
            self._on_corrupt(key, height)
            return None

    def _on_corrupt(self, key: bytes, height: Optional[int]) -> None:
        self._note_corruption(f"corrupt entry at key {key!r}")
        if height is not None:
            self.quarantine(height, f"corrupt entry {key!r}")

    def _note_corruption(self, detail: str) -> None:
        sh = self.storage_health
        if sh is not None:
            sh.note_corruption("blockstore", detail)

    # -- bookkeeping ---------------------------------------------------------
    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return self._height - self._base + 1 if self._height else 0

    def _save_state(self) -> None:
        self.db.set(_K_STATE, seal(codec.dumps({"base": self._base, "height": self._height})))

    # -- saving ------------------------------------------------------------
    def save_block(self, block: Block, part_set: PartSet, seen_commit: Commit) -> None:
        """store/store.go:270 — meta + parts + canonical last-commit of the
        previous block + our seen-commit for this block."""
        if block is None:
            raise ValueError("cannot save nil block")
        height = block.height
        with self._mtx:
            expected = self._height + 1 if self._height else height
            if height != expected:
                raise ValueError(f"cannot save block at height {height}, expected {expected}")
            if not part_set.is_complete():
                raise ValueError("cannot save block with incomplete part set")

            block_id = BlockID(block.hash(), part_set.header())
            meta = BlockMeta(block_id, len(block.serialize()), block.header, len(block.txs))
            sets = [
                (_k_meta(height), seal(codec.dumps(meta))),
                (_k_block_hash(block.hash()), seal(b"%d" % height)),
            ]
            for i in range(part_set.total):
                sets.append((_k_part(height, i), seal(codec.dumps(part_set.get_part(i)))))
            if block.last_commit is not None:
                sets.append((_k_commit(height - 1), seal(codec.dumps(block.last_commit))))
            sets.append((_k_seen_commit(height), seal(codec.dumps(seen_commit))))
            self.db.write_batch(sets)
            if self._base == 0:
                self._base = height
            self._height = height
            self._save_state()

    def bootstrap_light_block(self, header: Header, block_id: BlockID, seen_commit: Commit) -> None:
        """Statesync bootstrap (store/store.go SaveSeenCommit flavor):
        persist the lite2-verified header + its commit at the snapshot
        height into an EMPTY store, so consensus can reconstruct the last
        commit and RPC `/commit` can serve the trust root to other light
        clients.  No block parts exist — `load_block` at this height stays
        None and fastsync serves `no_block_response` for it."""
        height = header.height
        with self._mtx:
            if self._height != 0:
                raise ValueError(
                    f"cannot bootstrap light block at {height}: store already at {self._height}"
                )
            meta = BlockMeta(block_id, 0, header, 0)
            self.db.write_batch([
                (_k_meta(height), seal(codec.dumps(meta))),
                (_k_block_hash(block_id.hash), seal(b"%d" % height)),
                (_k_commit(height), seal(codec.dumps(seen_commit))),
                (_k_seen_commit(height), seal(codec.dumps(seen_commit))),
            ])
            self._base = height
            self._height = height
            self._save_state()

    # -- loading -----------------------------------------------------------
    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        if height in self._quarantined:
            return None
        return self._load(_k_meta(height), height)

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        if height in self._quarantined:
            return None
        return self._load(_k_part(height, index), height)

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        chunks = []
        for i in range(meta.block_id.parts_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            chunks.append(part.bytes)
        try:
            block = Block.deserialize(b"".join(chunks))
        except Exception:
            self._on_corrupt(_k_part(height, 0), height)
            return None
        # the deep check: per-entry seals protect sealed entries, the
        # recomputed block hash protects EVERYTHING (incl. legacy unsealed
        # parts) — a store must never SERVE a block whose content no
        # longer matches the identity it claims for it
        if block.hash() != meta.block_id.hash:
            self._on_corrupt(_k_meta(height), height)
            return None
        return block

    def load_block_by_hash(self, h: bytes) -> Optional[Block]:
        # the hash pointer's payload is a raw ascii height, not codec bytes
        payload, corrupt = self._get(_k_block_hash(h))
        if corrupt:
            self._note_corruption(f"corrupt hash pointer {h.hex()[:16]}")
            return None
        if payload is None:
            return None
        try:
            height = int(payload)
        except ValueError:
            self._note_corruption(f"undecodable hash pointer {h.hex()[:16]}")
            return None
        return self.load_block(height)

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """Canonical commit for height (from block height+1's LastCommit).
        Commit rot does NOT quarantine `height` (its block content is
        fine) — it repairs from the seen commit when possible, else
        quarantines height+1, whose refilled block CARRIES this commit as
        its last_commit."""
        return self._load_commit(height, _k_commit(height), _k_seen_commit(height))

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        """Locally-seen commit (may be for a later round than canonical)."""
        return self._load_commit(height, _k_seen_commit(height), _k_commit(height))

    def _load_commit(self, height: int, key: bytes, fallback_key: bytes):
        payload, corrupt = self._get(key)
        if not corrupt and payload is not None:
            try:
                return codec.loads(payload)
            except Exception:
                corrupt = True
        if not corrupt:
            return None  # genuinely absent
        self._note_corruption(f"corrupt commit entry {key!r}")
        # repair in place from the sibling entry: canonical and seen are
        # both valid commits for this height (seen may be a later round —
        # an acceptable substitute in either direction)
        fb_payload, fb_corrupt = self._get(fallback_key)
        if not fb_corrupt and fb_payload is not None:
            try:
                commit = codec.loads(fb_payload)
            except Exception:
                commit = None
            if commit is not None:
                self.db.set(key, seal(fb_payload))
                return commit
        # both rotted: only block height+1 (whose last_commit IS this
        # commit) can restore it — quarantine the carrier for refill
        with self._mtx:
            carrier_in_range = height + 1 <= self._height
        if carrier_in_range:
            self.quarantine(height + 1, f"carries rotted commit for {height}")
        return None

    # -- quarantine + self-healing ------------------------------------------
    def quarantined(self) -> List[int]:
        with self._mtx:
            return sorted(self._quarantined)

    def quarantine(self, height: int, reason: str = "") -> None:
        """Mark a height corrupt: every load answers None until a verified
        copy is restored.  Persisted so a restart remembers; the
        on_quarantine hook queues the height for peer refill no matter
        WHICH path detected the rot (scan or a read tripping over it)."""
        with self._mtx:
            if height in self._quarantined:
                return
            self._quarantined.add(height)
            self._save_quarantine()
            total = len(self._quarantined)
        sh = self.storage_health
        if sh is not None:
            sh.note_quarantine("blockstore", height, reason, total=total)
        if self.on_quarantine is not None:
            try:
                self.on_quarantine(height)
            except Exception:
                pass  # the refill kick must never break a load path

    def _save_quarantine(self) -> None:
        self.db.set(_K_QUARANTINE, seal(codec.dumps(sorted(self._quarantined))))

    def quarantine_expected_hash(self, height: int) -> Optional[bytes]:
        """The hash a refilled block at `height` must carry, derived from
        the strongest surviving evidence: our own meta, else the canonical
        commit (from block height+1), else our seen commit, else the NEXT
        header's last_block_id.  Reads bypass the quarantine gate — the
        point is recovering the identity of a quarantined height."""
        meta = self._load(_k_meta(height))
        if meta is not None and meta.block_id.hash:
            return meta.block_id.hash
        for key in (_k_commit(height), _k_seen_commit(height)):
            commit = self._load(key)
            if commit is not None and commit.block_id.hash:
                return commit.block_id.hash
        next_meta = self._load(_k_meta(height + 1))
        if next_meta is not None and next_meta.header.last_block_id is not None:
            h = next_meta.header.last_block_id.hash
            return h or None
        return None

    def restore_block(self, height: int, block: Block) -> None:
        """Refill a quarantined height from a peer-fetched block, verified
        against quarantine_expected_hash.  Rewrites meta + parts + hash
        pointer (+ the previous height's canonical commit, which the
        refetched block carries) and lifts the quarantine."""
        from ..types.params import BLOCK_PART_SIZE_BYTES

        expected = self.quarantine_expected_hash(height)
        if expected is None:
            raise ValueError(f"no surviving identity for height {height}; cannot verify refill")
        if block.hash() != expected:
            raise ValueError(
                f"refill block hash {block.hash().hex()[:16]} != expected {expected.hex()[:16]}"
            )
        part_set = block.make_part_set(BLOCK_PART_SIZE_BYTES)
        block_id = BlockID(block.hash(), part_set.header())
        meta = BlockMeta(block_id, len(block.serialize()), block.header, len(block.txs))
        with self._mtx:
            sets = [
                (_k_meta(height), seal(codec.dumps(meta))),
                (_k_block_hash(block.hash()), seal(b"%d" % height)),
            ]
            for i in range(part_set.total):
                sets.append((_k_part(height, i), seal(codec.dumps(part_set.get_part(i)))))
            if block.last_commit is not None and height > self._base:
                sets.append((_k_commit(height - 1), seal(codec.dumps(block.last_commit))))
            self.db.write_batch(sets)
            self._quarantined.discard(height)
            self._save_quarantine()
            total = len(self._quarantined)
        sh = self.storage_health
        if sh is not None:
            sh.note_refill("blockstore", height, total=total)

    def integrity_scan(self, limit: int = 0) -> dict:
        """Verify stored blocks content-vs-identity: per-entry seals, part
        reassembly and the recomputed block hash against the meta.  Newly
        found content corruption is quarantined at ITS height; rotted
        commit entries are repaired in place from their sibling
        (canonical <-> seen) when possible and otherwise quarantine the
        CARRIER height (h+1 stores this commit inside its block), whose
        refill rewrites them.  `limit` > 0 bounds the sweep to the most
        recent N heights (boot-time budget); 0 scans base..tip.  Returns
        and remembers a report for storage_info / debug bundles."""
        t0 = time.monotonic()
        with self._mtx:
            lo, hi = self._base, self._height
        if hi and limit > 0:
            lo = max(lo, hi - limit + 1)
        corrupt: List[int] = []
        repaired: List[int] = []
        checked = 0
        for h in range(lo, hi + 1) if hi else []:
            if h in self._quarantined:
                continue
            checked += 1
            if not self._check_height(h):
                corrupt.append(h)
                self.quarantine(h, "integrity scan")
            if self._check_commits(h):
                repaired.append(h)
        report = {
            "from": lo if hi else 0,
            "to": hi,
            "checked": checked,
            "corrupt": corrupt,
            "repaired_commits": repaired,
            "quarantined": self.quarantined(),
            "ms": round((time.monotonic() - t0) * 1000.0, 3),
        }
        self.last_scan = report
        sh = self.storage_health
        if sh is not None:
            sh.note_scan(report)
        return report

    def _check_height(self, h: int) -> bool:
        """Block CONTENT check (meta + parts + recomputed hash) — commit
        entries have their own repair path (_check_commits)."""
        payload, corrupt_flag = self._get(_k_meta(h))
        if corrupt_flag:
            return False
        if payload is None:
            # pruned-or-missing inside base..tip: base moves on prune, so a
            # hole here is damage
            return False
        try:
            meta = codec.loads(payload)
        except Exception:
            return False
        if meta.block_size == 0 and meta.num_txs == 0:
            # statesync light-block bootstrap: header+commit only, parts
            # legitimately absent
            return True
        chunks = []
        for i in range(meta.block_id.parts_header.total):
            payload, corrupt_flag = self._get(_k_part(h, i))
            if corrupt_flag or payload is None:
                return False
            try:
                part = codec.loads(payload)
            except Exception:
                return False
            chunks.append(part.bytes)
        try:
            block = Block.deserialize(b"".join(chunks))
        except Exception:
            return False
        return block.hash() == meta.block_id.hash

    def _check_commits(self, h: int) -> bool:
        """Verify/repair the commit entries at h; returns True when a
        repair happened.  _load_commit does the real work: sibling repair
        first, else quarantine of the carrier height (h+1)."""
        repaired = False
        for key, fallback in (
            (_k_commit(h), _k_seen_commit(h)),
            (_k_seen_commit(h), _k_commit(h)),
        ):
            payload, corrupt_flag = self._get(key)
            if payload is not None and not corrupt_flag:
                try:
                    codec.loads(payload)
                    continue  # intact
                except Exception:
                    pass
            elif payload is None and not corrupt_flag:
                continue  # genuinely absent (e.g. C:tip before tip+1 lands)
            if self._load_commit(h, key, fallback) is not None:
                repaired = True
        return repaired

    # -- pruning -----------------------------------------------------------
    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below retain_height; returns count pruned
        (store/store.go:197)."""
        with self._mtx:
            if retain_height <= 0:
                raise ValueError(f"height must be greater than 0: {retain_height}")
            if retain_height > self._height:
                raise ValueError(
                    f"cannot prune beyond the latest height {self._height}: {retain_height}"
                )
            pruned = 0
            deletes = []
            for h in range(self._base, min(retain_height, self._height)):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                deletes.append(_k_meta(h))
                deletes.append(_k_block_hash(meta.block_id.hash))
                deletes.append(_k_commit(h))
                deletes.append(_k_seen_commit(h))
                for i in range(meta.block_id.parts_header.total):
                    deletes.append(_k_part(h, i))
                pruned += 1
            self.db.write_batch([], deletes)
            self._base = max(self._base, retain_height)
            self._save_state()
            # pruned heights leave quarantine (nothing left to refill)
            dropped = {h for h in self._quarantined if h < self._base}
            if dropped:
                self._quarantined -= dropped
                self._save_quarantine()
                if self.storage_health is not None:
                    self.storage_health.set_quarantined(
                        "blockstore", len(self._quarantined)
                    )
            return pruned
