"""Address book: persisted peer-address store with new/old buckets (the
port's copy of tendermint_tpu/p2p/pex/addrbook.py).

Reference parity: p2p/pex/addrbook.go:109 — addresses learned from PEX
land in "new" buckets (bucketed by source group so one peer can't own the
table); addresses that held a successful connection are promoted to "old"
buckets.  Selection is biased between the two tiers, eviction prefers the
worst address in the fullest bucket, and the whole book persists to JSON
(p2p/pex/file.go) so a restarting node redials the network it knew.

Asyncio-era redesign: the reference guards the book with a mutex and a
goroutine saving every 2 min; here the book is single-loop-owned and the
node saves on a spawned task + on stop.

The JAX book draws its bucket-hash salt from os.urandom and its picks and
selections from the module-global `random`, and reads time.time.  Here the
salt (`key`), the generator (`rng`, a random.Random) and the wall clock
(`now_fn`) are arguments: with the JAX book's salt, a generator seeded as
the global one and the same clock, this book places, picks, selects and
saves exactly as the JAX book does, and each loads the other's file.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...libs.autofile import fsync_dir
from ...libs.log import get_logger
from ..transport import parse_peer_addr
from ..trust import TrustMetricStore

NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
NEW_BUCKET_SIZE = 64
OLD_BUCKET_SIZE = 64
MAX_NEW_BUCKETS_PER_ADDRESS = 4  # addrbook.go maxNewBucketsPerAddress
GET_SELECTION_PERCENT = 23  # addrbook.go getSelectionPercent
MAX_GET_SELECTION = 250
BIAS_TOWARDS_NEW = 30  # % of picks from new buckets once connected a while


def _group_key(hostport: str, strict: bool) -> str:
    """addrbook.go groupKey flavor: /16 for routable IPv4, the literal
    host otherwise.  Local addresses collapse to one group in non-strict
    (test) mode so bucketing still spreads by port."""
    host = hostport.rsplit(":", 1)[0]
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        if strict and (parts[0] == "127" or parts[0] == "0"):
            return "local"
        return f"{parts[0]}.{parts[1]}"
    return host


@dataclass
class KnownAddress:
    """addrbook.go knownAddress."""

    addr: str  # "id@host:port"
    src: str  # node id that told us
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    bucket_type: str = "new"
    buckets: List[int] = field(default_factory=list)
    # persisted snapshot of the time-decaying trust score (p2p/trust.py);
    # the live value lives in the book's TrustMetricStore
    trust: float = 1.0

    @property
    def peer_id(self) -> str:
        return parse_peer_addr(self.addr)[0]

    def is_old(self) -> bool:
        return self.bucket_type == "old"

    def is_bad(self, now: Optional[float] = None) -> bool:
        """addrbook.go isBad: too many failed attempts and no recent success."""
        now = now if now is not None else time.time()
        if self.last_attempt and now - self.last_attempt < 60:
            return False  # recently tried: give it a grace period
        if self.attempts >= 3 and not self.last_success:
            return True
        return self.attempts >= 10

    def to_dict(self) -> dict:
        return {
            "addr": self.addr,
            "src": self.src,
            "attempts": self.attempts,
            "last_attempt": self.last_attempt,
            "last_success": self.last_success,
            "bucket_type": self.bucket_type,
            "buckets": list(self.buckets),
            "trust": self.trust,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "KnownAddress":
        return cls(
            addr=d["addr"],
            src=d.get("src", ""),
            attempts=int(d.get("attempts", 0)),
            last_attempt=float(d.get("last_attempt", 0.0)),
            last_success=float(d.get("last_success", 0.0)),
            bucket_type=d.get("bucket_type", "new"),
            buckets=[int(b) for b in d.get("buckets", [])],
            trust=float(d.get("trust", 1.0)),
        )


class AddrBook:
    """p2p/pex/addrbook.go:109."""

    def __init__(
        self,
        file_path: str = "",
        strict: bool = True,
        our_ids: Optional[set] = None,
        private_ids: Optional[set] = None,
        key: Optional[str] = None,
        rng: Optional[random.Random] = None,
        now_fn=time.time,
    ):
        self.file_path = file_path
        self.strict = strict
        self.our_ids = our_ids or set()
        # private peers may be known and dialed but are NEVER gossiped
        # (pex_reactor.go AddPrivateIDs)
        self.private_ids = private_ids or set()
        self.addrs: Dict[str, KnownAddress] = {}  # peer id -> ka
        self.new_buckets: List[Dict[str, KnownAddress]] = [dict() for _ in range(NEW_BUCKET_COUNT)]
        self.old_buckets: List[Dict[str, KnownAddress]] = [dict() for _ in range(OLD_BUCKET_COUNT)]
        self.log = get_logger("addrbook")
        # per-book bucket-hash salt (a loaded file's key replaces it)
        self._key = key if key is not None else os.urandom(8).hex()
        # the draws of pick_address and get_selection
        self.rng = rng if rng is not None else random.Random()
        self._now = now_fn
        # time-decaying conduct scores (p2p/trust.py), fed by the switch
        # (dial failures, error stops) and behaviour reports; consulted by
        # pick_address and eviction
        self.trust = TrustMetricStore()
        if file_path and os.path.exists(file_path):
            self.load()

    # -- bucketing ---------------------------------------------------------

    def _bucket_idx_new(self, ka: KnownAddress) -> int:
        data = f"{self._key}:{_group_key(ka.addr.split('@')[-1], self.strict)}:" \
               f"{_group_key((ka.src or ka.addr).split('@')[-1], self.strict)}"
        return int.from_bytes(hashlib.sha256(data.encode()).digest()[:4], "big") % NEW_BUCKET_COUNT

    def _bucket_idx_old(self, ka: KnownAddress) -> int:
        data = f"{self._key}:old:{_group_key(ka.addr.split('@')[-1], self.strict)}"
        return int.from_bytes(hashlib.sha256(data.encode()).digest()[:4], "big") % OLD_BUCKET_COUNT

    # -- mutation ----------------------------------------------------------

    def add_address(self, addr: str, src: str = "") -> bool:
        """addrbook.go AddAddress: into a new bucket; False when rejected."""
        pid, hostport = parse_peer_addr(addr)
        if not pid or pid in self.our_ids:
            return False
        ka = self.addrs.get(pid)
        if ka is not None:
            if ka.is_old():
                return False  # already promoted; don't demote/rebucket
            if len(ka.buckets) >= MAX_NEW_BUCKETS_PER_ADDRESS:
                return False
            ka.src = ka.src or src
        else:
            ka = KnownAddress(addr=addr, src=src)
            self.addrs[pid] = ka
        idx = self._bucket_idx_new(ka)
        bucket = self.new_buckets[idx]
        if pid in bucket:
            return True
        if len(bucket) >= NEW_BUCKET_SIZE:
            self._evict_from_new(idx)
        bucket[pid] = ka
        if idx not in ka.buckets:
            ka.buckets.append(idx)
        return True

    def _evict_from_new(self, idx: int) -> None:
        bucket = self.new_buckets[idx]
        if not bucket:
            return
        worst_id = max(
            bucket,
            key=lambda p: (
                bucket[p].is_bad(self._now()),
                # lowest trust evicts first (score decays on bad conduct)
                round(1.0 - self.trust_value(p), 4),
                bucket[p].attempts,
                -bucket[p].last_success,
            ),
        )
        ka = bucket.pop(worst_id)
        if idx in ka.buckets:
            ka.buckets.remove(idx)
        if not ka.buckets:
            self.addrs.pop(worst_id, None)

    def mark_attempt(self, addr_or_id: str) -> None:
        ka = self._lookup(addr_or_id)
        if ka:
            ka.attempts += 1
            ka.last_attempt = self._now()

    def mark_failed(self, addr_or_id: str) -> None:
        """Bad-conduct trust event (failed dial, error stop, behaviour
        report) WITHOUT removing the address — the score decay, not a
        ban, is what demotes the peer in dial selection."""
        pid = parse_peer_addr(addr_or_id)[0] if "@" in addr_or_id else addr_or_id
        if pid:
            self.trust.event(pid, good=False)
            ka = self.addrs.get(pid)
            if ka is not None:
                ka.trust = self.trust.value(pid)

    def trust_value(self, addr_or_id: str) -> float:
        pid = parse_peer_addr(addr_or_id)[0] if "@" in addr_or_id else addr_or_id
        return self.trust.value(pid)

    def mark_good(self, addr_or_id: str) -> None:
        """addrbook.go MarkGood: promote to an old bucket."""
        ka = self._lookup(addr_or_id)
        if ka is None:
            return
        self.trust.event(ka.peer_id, good=True)
        ka.trust = self.trust.value(ka.peer_id)
        ka.attempts = 0
        ka.last_success = self._now()
        ka.last_attempt = ka.last_success
        if ka.is_old():
            return
        for idx in ka.buckets:
            self.new_buckets[idx].pop(ka.peer_id, None)
        ka.buckets.clear()
        ka.bucket_type = "old"
        idx = self._bucket_idx_old(ka)
        bucket = self.old_buckets[idx]
        if len(bucket) >= OLD_BUCKET_SIZE:
            # displace the worst old entry back to new (addrbook.go moveToOld)
            worst_id = max(bucket, key=lambda p: (bucket[p].attempts, -bucket[p].last_success))
            demoted = bucket.pop(worst_id)
            demoted.bucket_type = "new"
            demoted.buckets.clear()
            nidx = self._bucket_idx_new(demoted)
            self.new_buckets[nidx][worst_id] = demoted
            demoted.buckets.append(nidx)
        bucket[ka.peer_id] = ka
        ka.buckets.append(idx)

    def mark_bad(self, addr_or_id: str) -> None:
        """Remove entirely (addrbook.go MarkBad banishes)."""
        ka = self._lookup(addr_or_id)
        if ka is None:
            return
        self.remove_address(ka.peer_id)

    def remove_address(self, addr_or_id: str) -> None:
        ka = self._lookup(addr_or_id)
        if ka is None:
            return
        pid = ka.peer_id
        for idx in ka.buckets:
            tier = self.old_buckets if ka.is_old() else self.new_buckets
            tier[idx].pop(pid, None)
        self.addrs.pop(pid, None)

    def _lookup(self, addr_or_id: str) -> Optional[KnownAddress]:
        pid = parse_peer_addr(addr_or_id)[0] if "@" in addr_or_id else addr_or_id
        return self.addrs.get(pid)

    # -- selection ---------------------------------------------------------

    def size(self) -> int:
        return len(self.addrs)

    def is_empty(self) -> bool:
        return not self.addrs

    def need_more_addrs(self) -> bool:
        return self.size() < 1000  # addrbook.go needAddressThreshold

    def pick_address(self, bias_towards_new: int = BIAS_TOWARDS_NEW) -> Optional[str]:
        """addrbook.go PickAddress — random non-bad address, tier chosen by
        bias (% chance of a new-bucket address).  Dial priority consults
        the trust score: once any candidate is meaningfully trusted, peers
        whose score has decayed below half the best score stop winning
        selection (they stay in the book and recover as their history
        fades — p2p/trust parity, the VERDICT-missing wiring)."""
        if self.is_empty():
            return None
        now = self._now()
        candidates_old = [ka for ka in self.addrs.values() if ka.is_old() and not ka.is_bad(now)]
        candidates_new = [ka for ka in self.addrs.values() if not ka.is_old() and not ka.is_bad(now)]
        if not candidates_old and not candidates_new:
            return None
        # trust gate ACROSS tiers: a tier containing only degraded peers
        # must not win just because the bias coin chose it
        scores = {
            ka.peer_id: self.trust.value(ka.peer_id)
            for ka in candidates_old + candidates_new
        }
        best = max(scores.values())
        trusted_old = [ka for ka in candidates_old if scores[ka.peer_id] >= 0.5 * best]
        trusted_new = [ka for ka in candidates_new if scores[ka.peer_id] >= 0.5 * best]
        use_new = self.rng.randrange(100) < bias_towards_new
        pool = (
            (trusted_new if use_new else trusted_old)
            or trusted_old
            or trusted_new
            # every candidate is degraded: dial SOMEONE rather than stall
            or candidates_old
            or candidates_new
        )
        return self.rng.choice(pool).addr

    def get_selection(self) -> List[str]:
        """addrbook.go GetSelection — random ≤23% (cap 250) for PEX."""
        if self.is_empty():
            return []
        all_addrs = [
            ka.addr for pid, ka in self.addrs.items() if pid not in self.private_ids
        ]
        if not all_addrs:
            return []
        n = max(min(len(all_addrs), 32), len(all_addrs) * GET_SELECTION_PERCENT // 100)
        n = min(n, MAX_GET_SELECTION, len(all_addrs))
        return self.rng.sample(all_addrs, n)

    def has_address(self, addr_or_id: str) -> bool:
        return self._lookup(addr_or_id) is not None

    # -- persistence (p2p/pex/file.go) -------------------------------------

    def save(self) -> None:
        if not self.file_path:
            return
        os.makedirs(os.path.dirname(self.file_path) or ".", exist_ok=True)
        for pid, ka in self.addrs.items():
            # snapshot live scores so a restart remembers who was flaky
            if pid in self.trust.metrics:
                ka.trust = self.trust.value(pid)
        payload = {
            "key": self._key,
            "addrs": [ka.to_dict() for ka in self.addrs.values()],
        }
        tmp = self.file_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.file_path)
        # rename atomicity needs a directory fsync to survive power loss,
        # or the whole book can vanish (see libs/autofile.fsync_dir)
        fsync_dir(self.file_path)

    def load(self) -> None:
        try:
            with open(self.file_path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            self.log.error("addrbook load failed", err=str(e))
            return
        self._key = payload.get("key", self._key)
        for d in payload.get("addrs", []):
            try:
                ka = KnownAddress.from_dict(d)
            except (KeyError, ValueError):
                continue
            pid = ka.peer_id
            if not pid or pid in self.our_ids:
                continue
            self.addrs[pid] = ka
            self.trust.seed(pid, ka.trust)
            ka.buckets.clear()
            if ka.is_old():
                idx = self._bucket_idx_old(ka)
                self.old_buckets[idx][pid] = ka
                ka.buckets.append(idx)
            else:
                idx = self._bucket_idx_new(ka)
                self.new_buckets[idx][pid] = ka
                ka.buckets.append(idx)
