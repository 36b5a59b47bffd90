"""Session manager: per-tenant trust roots over one shared light store (the
port's copy of tendermint_tpu/liteserve/sessions.py; the JAX module reads
time.monotonic, this one the manager's `now_fn`).

A session is what makes the gateway multi-tenant rather than merely
cached: each tenant brings its OWN subjective trust root (height + header
hash) — the thing a light client must never outsource — while the
objective work (commit verification, witness cross-checks, provider
round-trips) is shared across all of them.

Admission discipline reuses the PR 11 overload layer verbatim:

  - the session table is BOUNDED (`max_sessions`); when full, idle
    sessions past `idle_timeout_s` are evicted LRU-first, and if none are
    idle the create is rejected with an explicit ``-32005
    SERVER_OVERLOADED`` + retry_after — never silent queueing;
  - session creation is rate-limited per source address
    (`libs/flowrate.TokenBucket.allow`), and each session carries its own
    request bucket — one hot tenant exhausts its own budget, not the
    gateway.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..libs.flowrate import TokenBucket
from ..libs.log import get_logger
from ..rpc.jsonrpc import RPCError, INVALID_PARAMS, overloaded_error


@dataclass
class Session:
    sid: str
    source: str
    trust_height: int
    trust_hash: bytes
    created: float
    last_active: float
    bucket: Optional[TokenBucket]
    requests: int = 0
    bisections: int = 0
    # tenants that bring their own providers (b.y.o.-primary) get a
    # private client; None means the session rides the shared engine
    private_client: object = None
    rooted: bool = False  # trust root checked against the shared chain
    now_fn: Callable[[], float] = field(default=time.monotonic, repr=False)

    def touch(self, n: float = 1.0) -> None:
        self.last_active = self.now_fn()
        self.requests += 1

    def admit(self) -> None:
        """Per-session request admission; explicit overload on exhaustion."""
        now = self.now_fn()
        self.last_active = now
        self.requests += 1
        if self.bucket is not None and not self.bucket.allow(now=now):
            raise overloaded_error(
                f"session {self.sid} request rate exceeded",
                self.bucket.retry_after(now=now),
            )


class SessionManager:
    def __init__(
        self,
        max_sessions: int = 4096,
        idle_timeout_s: float = 300.0,
        session_rate: float = 0.0,        # per-session requests/sec (0 = off)
        session_burst: int = 50,
        create_rate: float = 0.0,         # per-source creates/sec (0 = off)
        create_burst: int = 20,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        self._now = now_fn
        self.max_sessions = max_sessions
        self.idle_timeout_s = idle_timeout_s
        self.session_rate = session_rate
        self.session_burst = session_burst
        self.create_rate = create_rate
        self.create_burst = create_burst
        self.sessions: Dict[str, Session] = {}
        self._create_buckets: Dict[str, TokenBucket] = {}
        self.created_total = 0
        self.evicted_total = 0
        self.resumed_total = 0
        self.log = get_logger("liteserve.sessions")

    # -- lifecycle ---------------------------------------------------------

    def create(self, source: str, trust_height: int, trust_hash: bytes) -> Session:
        if trust_height < 1 or len(trust_hash) != 32:
            raise RPCError(INVALID_PARAMS, "trust_height >= 1 and 32-byte trust_hash required")
        now = self._now()
        if self.create_rate > 0:
            bucket = self._create_buckets.get(source)
            if bucket is None:
                bucket = self._create_buckets[source] = TokenBucket(
                    self.create_rate, self.create_burst, now=now
                )
                # the per-source bucket table must not grow unboundedly on
                # spoofed sources; cheapest discipline: hard cap + reset
                if len(self._create_buckets) > 4 * self.max_sessions:
                    self._create_buckets = {source: bucket}
            if not bucket.allow(now=now):
                raise overloaded_error(
                    f"session create rate exceeded for {source}", bucket.retry_after(now=now)
                )
        if len(self.sessions) >= self.max_sessions:
            self._evict_idle()
        if len(self.sessions) >= self.max_sessions:
            raise overloaded_error(
                f"session table full ({self.max_sessions})", self.idle_timeout_s
            )
        sid = secrets.token_hex(12)
        now = self._now()
        sess = Session(
            sid=sid,
            source=source,
            trust_height=trust_height,
            trust_hash=trust_hash,
            created=now,
            last_active=now,
            bucket=TokenBucket(self.session_rate, self.session_burst, now=now)
            if self.session_rate > 0 else None,
            now_fn=self._now,
        )
        self.sessions[sid] = sess
        self.created_total += 1
        return sess

    def get(self, sid: str) -> Session:
        sess = self.sessions.get(sid)
        if sess is None:
            raise RPCError(INVALID_PARAMS, f"unknown or expired session {sid!r}")
        return sess

    def resume(self, sid: str) -> Session:
        """Resume semantics: an evicted session is gone (its trust root was
        the tenant's to keep), but a live one revalidates cheaply."""
        sess = self.get(sid)
        sess.last_active = self._now()
        self.resumed_total += 1
        return sess

    def drop(self, sid: str) -> None:
        self.sessions.pop(sid, None)

    def _evict_idle(self) -> None:
        now = self._now()
        idle = [
            s for s in self.sessions.values()
            if now - s.last_active > self.idle_timeout_s
        ]
        idle.sort(key=lambda s: s.last_active)
        for s in idle:
            del self.sessions[s.sid]
            self.evicted_total += 1
        if idle:
            self.log.info("evicted idle sessions", n=len(idle))

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "sessions": len(self.sessions),
            "max_sessions": self.max_sessions,
            "created": self.created_total,
            "resumed": self.resumed_total,
            "evicted": self.evicted_total,
        }
