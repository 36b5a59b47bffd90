"""Flow-rate measurement and limiting (the port's copy of
tendermint_tpu/libs/flowrate.py).

Reference parity: libs/flowrate/flowrate.go (Monitor) — tracks bytes
transferred, instantaneous and average rates, and peak, for the p2p
connection status surface (rpc net_info) and fast-sync progress display.
`TokenBucket` is the LIMITER half (flowrate.go Limit/Monitor.Limit): RPC
ingress admission control and mempool-gossip pacing both draw from it.

Redesign: the reference's Monitor samples with a mutex-guarded clock; here
a single-loop-owned exponential moving average over update intervals
suffices (mconn send/recv routines own their meters)."""

from __future__ import annotations

import time


class Meter:
    """Byte-flow meter with an EMA instantaneous rate."""

    SAMPLE_PERIOD = 0.5  # seconds per EMA sample bucket
    ALPHA = 0.4  # EMA weight of the newest bucket

    def __init__(self, now: float = None):
        t = now if now is not None else time.monotonic()
        self.start = t
        self.total = 0  # bytes since start
        self.rate = 0.0  # EMA bytes/sec
        self.peak = 0.0  # max observed EMA rate
        self._bucket_start = t
        self._bucket_bytes = 0

    def update(self, n: int, now: float = None) -> None:
        t = now if now is not None else time.monotonic()
        self.total += n
        self._bucket_bytes += n
        elapsed = t - self._bucket_start
        if elapsed >= self.SAMPLE_PERIOD:
            inst = self._bucket_bytes / elapsed
            # decay across skipped sample periods so idle links drop to ~0
            periods = min(int(elapsed / self.SAMPLE_PERIOD), 32)
            rate = self.rate
            for _ in range(periods - 1):
                rate *= 1 - self.ALPHA
            self.rate = rate * (1 - self.ALPHA) + inst * self.ALPHA
            self.peak = max(self.peak, self.rate)
            self._bucket_start = t
            self._bucket_bytes = 0

    def avg_rate(self, now: float = None) -> float:
        t = now if now is not None else time.monotonic()
        dt = t - self.start
        return self.total / dt if dt > 0 else 0.0

    def cur_rate(self, now: float = None) -> float:
        """EMA rate decayed to the read time — an idle link reads ~0, not
        its last burst (the Go Monitor likewise decays on read)."""
        t = now if now is not None else time.monotonic()
        idle = t - self._bucket_start
        periods = min(int(idle / self.SAMPLE_PERIOD), 32)
        rate = self.rate
        for _ in range(periods):
            rate *= 1 - self.ALPHA
        return rate

    def status(self, now: float = None) -> dict:
        """flowrate.go Status flavor."""
        t = now if now is not None else time.monotonic()
        return {
            "duration_s": round(t - self.start, 3),
            "bytes": self.total,
            "cur_rate": round(self.cur_rate(t), 1),
            "avg_rate": round(self.avg_rate(t), 1),
            "peak_rate": round(self.peak, 1),
        }


class TokenBucket:
    """Token-bucket limiter: `rate` tokens/sec refill, capacity `burst`.

    Two disciplines share the one bucket:

      - ``allow(n)``: strict admission — consume n tokens iff they are
        available NOW, else leave the bucket untouched.  RPC ingress uses
        this to reject with an explicit overload error (plus
        ``retry_after`` as the client hint) instead of queueing.
      - ``debit(n)``: pacing — consume unconditionally (the balance may go
        negative) and return the seconds the caller should sleep before
        its next send.  Mempool gossip uses this so a frame larger than
        the burst spreads out over time instead of never qualifying.

    `now` is injectable everywhere (monotonic seconds) for deterministic
    tests; callers on the event loop need no locking.
    """

    def __init__(self, rate: float, burst: float, now: float = None):
        if rate <= 0:
            raise ValueError("TokenBucket rate must be > 0")
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self._t = now if now is not None else time.monotonic()

    def _refill(self, now: float = None) -> None:
        t = now if now is not None else time.monotonic()
        if t > self._t:
            self.tokens = min(self.burst, self.tokens + (t - self._t) * self.rate)
            self._t = t

    def allow(self, n: float = 1.0, now: float = None) -> bool:
        """Consume `n` tokens iff available; False leaves the bucket as-is."""
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0, now: float = None) -> float:
        """Seconds until `n` tokens (capped at burst — an over-burst ask
        would otherwise be 'never') will be available; 0 if already are."""
        self._refill(now)
        need = min(n, self.burst) - self.tokens
        return max(0.0, need / self.rate)

    def debit(self, n: float, now: float = None) -> float:
        """Unconditionally charge `n` tokens and return the pacing delay
        (seconds until the balance would be non-negative again)."""
        self._refill(now)
        self.tokens -= n
        return max(0.0, -self.tokens / self.rate)
