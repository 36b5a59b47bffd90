"""GPU batch verifier: batched ed25519 on the hand-written Hopper kernels.

The port's counterpart of tendermint_tpu/crypto/batch_verifier.py.  Split
of labor:
  host   — pubkey decompression (cached; one table per validator set),
           SHA-512 h = H(R‖A‖M), reduction mod L, structural prefilters
           (length, canonical S), in one threaded C pass (hostprep).
  device — [s]B + [h](−A) for the whole batch: kernel 1, the Straus ladder
           with the pubkey-row gather fused in (ops/ed25519_cuda.py), or,
           against a stable validator set, kernel 3, the zero-doubling sum
           over per-validator window tables built by kernel 2
           (ops/ed25519_table.py).

A CUDA kernel takes any batch size, so batches are not padded to buckets
and nothing is compiled per shape.  Every entry point takes `device`: None
means "cuda", and without a card it raises unless the caller passes
device="cpu", where the wrappers run their plain torch versions.
"""

from __future__ import annotations

import collections
import statistics
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import batch as batch_hook
from . import ed25519_math as em

_N_LIMBS = 20
_LIMB_BITS = 13

IDENTITY_ROW = np.zeros((4, _N_LIMBS), dtype=np.int16)
IDENTITY_ROW[1, 0] = 1  # (0, 1, 1, 0): the placeholder row of an invalid key
IDENTITY_ROW[2, 0] = 1


def resolve_device(device=None) -> torch.device:
    """None means the card.  Never drifts onto the CPU: without CUDA this
    raises unless the caller asked for the CPU explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain torch versions"
        )
    return dev


# ---------------------------------------------------------------------------
# host-side preparation
# ---------------------------------------------------------------------------

# Bounded LRU: pubkeys are attacker-suppliable, so the cache must not grow
# without limit.  64k entries of [4, 20] int16 ≈ 10 MB worst case.
_DECOMPRESS_CACHE_MAX = 65536
_decompress_cache: "collections.OrderedDict[bytes, Optional[np.ndarray]]" = (
    collections.OrderedDict()
)
_decompress_lock = threading.Lock()


def _neg_a_limbs(pubkey: bytes) -> Optional[np.ndarray]:
    """Decompress pubkey and return extended coords of −A as [4, 20] int16
    13-bit limbs; None for invalid encodings.  LRU-cached."""
    with _decompress_lock:
        if pubkey in _decompress_cache:
            _decompress_cache.move_to_end(pubkey)
            return _decompress_cache[pubkey]
    aff = em.decompress(pubkey)
    if aff is None:
        limbs = None
    else:
        x, y = aff
        nx = (em.P - x) % em.P
        ext = (nx, y, 1, nx * y % em.P)
        limbs = np.zeros((4, _N_LIMBS), dtype=np.int16)
        for c in range(4):
            v = ext[c]
            for i in range(_N_LIMBS):
                limbs[c, i] = (v >> (_LIMB_BITS * i)) & ((1 << _LIMB_BITS) - 1)
    with _decompress_lock:
        _decompress_cache[pubkey] = limbs
        if len(_decompress_cache) > _DECOMPRESS_CACHE_MAX:
            _decompress_cache.popitem(last=False)
    return limbs


def _msb_digits(values_le: np.ndarray) -> np.ndarray:
    """[B, 32] little-endian scalar byte rows -> [B, 64] 4-bit window
    digits, most-significant digit first (the ladder's order)."""
    dig = np.empty((values_le.shape[0], 64), dtype=np.uint8)
    dig[:, 0::2] = values_le & 15
    dig[:, 1::2] = values_le >> 4
    return dig[:, ::-1]


def _pack_digits(digits: np.ndarray) -> np.ndarray:
    """[B, 64] 4-bit MSB-first window digits -> [B, 32] little-endian scalar
    bytes — inverse of _msb_digits, exact.  The kernels take this packed
    form and expand it in their prologue."""
    rev = digits[:, ::-1]
    return (rev[:, 0::2] | (rev[:, 1::2].astype(np.uint8) << 4)).astype(np.uint8)


def _scalar_rows(
    items: Sequence[Optional[Tuple[bytes, bytes, bytes]]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Shared per-signature host prep: SHA-512 h, scalar s, raw R limbs,
    canonical-S / length prefilters.  `items[i]` is (pubkey, msg, sig) or
    None when the caller already knows entry i is invalid.  Returns
    (h_digits, s_digits, r_y_raw, r_sign, valid).

    Fast path: one fused, threaded C pass (hostprep.prep_scalar_rows).  The
    numpy pipeline below is the no-toolchain path and the differential-test
    reference."""
    from . import hostprep

    fused = hostprep.prep_scalar_rows(items)
    if fused is not None:
        return fused

    n = len(items)
    valid = np.zeros(n, dtype=bool)
    zeros32 = bytes(32)
    s_parts: list = [zeros32] * n
    r_parts: list = [zeros32] * n
    hash_parts: list = []
    hash_pos: list = []
    for i, item in enumerate(items):
        if item is None:
            continue
        pk, msg, sig = item
        if len(sig) != 64 or len(pk) != 32:
            continue
        s_parts[i] = sig[32:]
        r_parts[i] = sig[:32]
        hash_parts.append(sig[:32] + pk + msg)
        hash_pos.append(i)
        valid[i] = True
    s_le = np.frombuffer(b"".join(s_parts), dtype=np.uint8).reshape(n, 32)
    r_le = np.frombuffer(b"".join(r_parts), dtype=np.uint8).reshape(n, 32)
    valid &= hostprep.sc_minimal_rows(s_le)
    h_le = np.zeros((n, 32), dtype=np.uint8)
    if hash_parts:
        h_le[hash_pos] = hostprep.sha512_mod_l(hash_parts)
    r_y_raw = hostprep.limbs_from_le_bytes(r_le)
    r_sign = hostprep.sign_bits(r_le)
    return _msb_digits(h_le), _msb_digits(s_le), r_y_raw, r_sign, valid


def prepare_batch(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host prep: returns (neg_a [B,4,20], h_digits [B,64], s_digits [B,64],
    r_y_raw [B,20], r_sign [B], valid [B]).  Invalid pubkeys get the
    identity row (0, 1, 1, 0) and valid=False."""
    n = len(sigs)
    neg_a = np.broadcast_to(IDENTITY_ROW, (n, 4, _N_LIMBS)).copy()
    items: list = [None] * n
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        if len(pk) != 32:
            continue
        limbs = _neg_a_limbs(pk)
        if limbs is None:
            continue
        neg_a[i] = limbs
        items[i] = (pk, msg, sig)
    h_digits, s_digits, r_y_raw, r_sign, valid = _scalar_rows(items)
    return neg_a, h_digits, s_digits, r_y_raw, r_sign, valid


def _device_rows(device, idx, h_digits, s_digits, r_y, r_sign):
    """Per-signature host arrays -> the kernels' device tensors."""
    return (
        torch.as_tensor(np.ascontiguousarray(idx, dtype=np.int32), device=device),
        torch.as_tensor(_pack_digits(h_digits), device=device),
        torch.as_tensor(_pack_digits(s_digits), device=device),
        torch.as_tensor(np.ascontiguousarray(r_y, dtype=np.int16), device=device),
        torch.as_tensor(np.ascontiguousarray(r_sign, dtype=np.uint8), device=device),
    )


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1000


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------


class BatchVerifier:
    """Batched ed25519 verification of per-call (pubkey, msg, sig) triples
    on kernel 1.

    `min_device_batch` is a routing rule: batches smaller than it verify on
    the serial host path (crypto.batch.host_batch_verify).  1 = always the
    device.  `last_dispatch` holds the host-prep and device times of the
    most recent call, for the smoke run and benchmarks."""

    def __init__(self, device=None, min_device_batch: int = 1):
        self.device = resolve_device(device)
        self.min_device_batch = min_device_batch
        self.last_dispatch: Dict[str, object] = {}

    def verify(
        self, pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
    ) -> List[bool]:
        from ..ops import ed25519_cuda

        n = len(sigs)
        if n == 0:
            return []
        if n < self.min_device_batch:
            t0 = time.perf_counter()
            out = batch_hook.host_batch_verify(pubkeys, msgs, sigs)
            self.last_dispatch = {"path": "host", "n": n, "host_prep_ms": 0.0,
                                  "device_ms": _ms_since(t0)}
            return out
        t0 = time.perf_counter()
        neg_a, h_digits, s_digits, r_y, r_sign, valid = prepare_batch(pubkeys, msgs, sigs)
        prep_ms = _ms_since(t0)
        if not valid.any():
            return [False] * n
        t1 = time.perf_counter()
        rows = torch.as_tensor(neg_a, device=self.device)
        ok = ed25519_cuda.verify_indexed(
            rows, *_device_rows(self.device, np.arange(n), h_digits, s_digits, r_y, r_sign)
        ).cpu().numpy()
        self.last_dispatch = {"path": "flat", "n": n, "host_prep_ms": prep_ms,
                              "device_ms": _ms_since(t1)}
        return np.logical_and(ok, valid).tolist()

    def install(self) -> "BatchVerifier":
        """Become the process-wide batch-verify hook used by
        ValidatorSet.verify_commit* when no indexed hook serves."""
        batch_hook.set_verifier(self.verify)
        return self


# One break-even profile per process and card: does the tabulated
# zero-doubling kernel beat the ladder at commit shapes?  See
# PubkeyTable._auto_tabulated.
_tabulated_verdict: Dict[str, bool] = {}
tabulated_profiles: Dict[str, Dict[str, float]] = {}
_tabulated_lock = threading.Lock()


def _event_ms(fn, stream) -> float:
    """Device ms of what one call of fn launches on `stream`, by CUDA events
    (the kernels' own clock)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end)


class PubkeyTable:
    """Device-resident decompressed validator pubkey table, keyed by
    validator index — commits verify by gathering rows inside the kernel.
    Rebuilt only on validator-set changes.

    `tabulated=True` additionally builds per-validator window tables
    (kernel 2) so commit verification needs zero point doublings (kernel 3).
    `tabulated=None` (the default) is AUTO: a one-time per-process profile
    times both kernels at the live commit size on this card and engages the
    tables only where they win.  On the CPU (plain versions) auto means
    off."""

    TABULATED_MAX_VALIDATORS = 16384  # ~2.6 GB of device tables

    def __init__(
        self,
        pubkeys: Sequence[bytes],
        verifier: Optional[BatchVerifier] = None,
        tabulated: Optional[bool] = None,
        device=None,
    ):
        self.verifier = verifier or BatchVerifier(device=device)
        self.device = self.verifier.device
        n = len(pubkeys)
        rows = np.broadcast_to(IDENTITY_ROW, (max(n, 1), 4, _N_LIMBS)).copy()
        row_valid = np.zeros(max(n, 1), dtype=bool)
        for i, pk in enumerate(pubkeys):
            limbs = _neg_a_limbs(bytes(pk))
            if limbs is not None:
                rows[i] = limbs
                row_valid[i] = True
        self.pubkeys = [bytes(pk) for pk in pubkeys]
        self.row_valid = row_valid
        self.neg_a_rows = torch.as_tensor(rows, device=self.device)
        self._window_tables: Optional[torch.Tensor] = None
        if n > self.TABULATED_MAX_VALIDATORS:
            tabulated = False
        self.tabulated = tabulated

    def __len__(self) -> int:
        return len(self.pubkeys)

    def build_tables(self) -> torch.Tensor:
        """One-time per validator set: device-built window tables."""
        if self._window_tables is None:
            from ..ops import ed25519_table

            self._window_tables = ed25519_table.build_window_tables(self.neg_a_rows)
        return self._window_tables

    def _tabulated_active(self, n: int) -> bool:
        if self.tabulated is None:
            self.tabulated = self._auto_tabulated(n)
        return self.tabulated

    def _auto_tabulated(self, n: int) -> bool:
        """Engage the tables only where a timed comparison on this card, at
        this commit's size, says kernel 3 beats kernel 1.  The verdict is
        cached per card name for the process."""
        if self.device.type != "cuda":
            return False
        key = torch.cuda.get_device_name(self.device)
        with _tabulated_lock:
            if key in _tabulated_verdict:
                return _tabulated_verdict[key]
        verdict = self._profile_tabulated(n, key)
        with _tabulated_lock:
            _tabulated_verdict.setdefault(key, verdict)
            return _tabulated_verdict[key]

    def _profile_tabulated(self, n: int, key: str) -> bool:
        """Time one tabulated dispatch vs one ladder dispatch at batch n, by
        CUDA events on the current stream, the kernels' own clock (a host
        clock adds uneven host work to each), median of 5 each after one
        untimed run.  Engages the tables when they are faster, the JAX
        package's rule.  Both kernels do the same work for any data, so the
        scalars are zero; signature i reads validator i's rows (mod the set
        size), the gather pattern of a commit.  A failing kernel raises."""
        from ..ops import ed25519_cuda, ed25519_table

        t0 = time.perf_counter()
        tables = self.build_tables()
        torch.cuda.synchronize()
        build_ms = _ms_since(t0)
        dev = self.device
        idx = (torch.arange(n, device=dev) % self.neg_a_rows.shape[0]).to(torch.int32)
        h = torch.zeros((n, 32), dtype=torch.uint8, device=dev)
        ry = torch.zeros((n, _N_LIMBS), dtype=torch.int16, device=dev)
        rs = torch.zeros(n, dtype=torch.uint8, device=dev)

        def run_tab():
            ed25519_table.verify_tabulated(tables, idx, h, h, ry, rs)

        def run_ladder():
            ed25519_cuda.verify_indexed(self.neg_a_rows, idx, h, h, ry, rs)

        stream = torch.cuda.current_stream(dev)
        run_tab()
        run_ladder()
        tab_ms = statistics.median(_event_ms(run_tab, stream) for _ in range(5))
        ladder_ms = statistics.median(_event_ms(run_ladder, stream) for _ in range(5))
        tabulated_profiles[key] = {
            "tab_ms": tab_ms, "ladder_ms": ladder_ms, "table_build_ms": build_ms,
            "batch": float(n), "validators": float(len(self.pubkeys)),
        }
        if tab_ms >= ladder_ms:
            self._window_tables = None  # the ladder serves: free 160 KB per validator
        return tab_ms < ladder_ms

    def verify_indexed(
        self, idxs: Sequence[int], msgs: Sequence[bytes], sigs: Sequence[bytes]
    ) -> List[bool]:
        """Verify msgs[i]/sigs[i] against table row idxs[i]."""
        from ..ops import ed25519_cuda, ed25519_table

        n = len(sigs)
        if n == 0:
            return []
        pk_count = len(self.pubkeys)
        if n < self.verifier.min_device_batch:
            return batch_hook.host_batch_verify(
                [self.pubkeys[i] if 0 <= i < pk_count else b"" for i in (int(i) for i in idxs)],
                msgs,
                sigs,
            )
        idx_arr = np.asarray(idxs, dtype=np.int64)
        items: list = [None] * n
        for i, (idx, msg, sig) in enumerate(zip(idx_arr.tolist(), msgs, sigs)):
            if 0 <= idx < pk_count and self.row_valid[idx]:
                items[i] = (self.pubkeys[idx], msg, sig)

        tab = self._tabulated_active(n)

        t0 = time.perf_counter()
        h_digits, s_digits, r_y, r_sign, valid = _scalar_rows(items)
        prep_ms = _ms_since(t0)
        if not valid.any():
            return [False] * n
        idx_arr = np.clip(idx_arr, 0, max(pk_count - 1, 0))
        t1 = time.perf_counter()
        args = _device_rows(self.device, idx_arr, h_digits, s_digits, r_y, r_sign)
        if tab:
            ok = ed25519_table.verify_tabulated(self.build_tables(), *args)
        else:
            ok = ed25519_cuda.verify_indexed(self.neg_a_rows, *args)
        ok = ok.cpu().numpy()
        self.verifier.last_dispatch = {
            "path": "tabulated" if tab else "indexed", "n": n,
            "host_prep_ms": prep_ms, "device_ms": _ms_since(t1),
        }
        return np.logical_and(ok, valid).tolist()


def from_jax_state(
    neg_a_rows: np.ndarray, window_tables: Optional[np.ndarray], device=None
) -> PubkeyTable:
    """A PubkeyTable whose device state is the JAX package's arrays: the
    [V, 4, 20] −A rows (PubkeyTable.neg_a_rows) and, optionally, the
    [V*1024, 4, 20] int16 window tables (build_window_tables).  Given
    tables, the table serves tabulated; without, it decides as AUTO.

    Host prep hashes the raw pubkeys, so they are re-encoded from the rows
    (A = (−x, y); decompression accepts only canonical encodings, so this
    round-trips).  Rows equal to the identity placeholder (0, 1, 1, 0) count
    as invalid keys: a validator whose key is the identity point itself is
    rejected, never accepted in place of an invalid key."""
    rows = np.ascontiguousarray(neg_a_rows).astype(np.int16)
    if rows.ndim != 3 or rows.shape[1:] != (4, _N_LIMBS):
        raise ValueError(f"neg_a_rows must be [V, 4, 20], got {rows.shape}")
    v = rows.shape[0]
    pubkeys = []
    for r in rows:
        nx, y = (sum(int(l) << (_LIMB_BITS * i) for i, l in enumerate(r[c])) for c in (0, 1))
        pubkeys.append(em.compress((em.P - nx) % em.P, y))
    table = PubkeyTable([], device=device, tabulated=True if window_tables is not None else None)
    table.pubkeys = pubkeys
    table.row_valid = ~(rows == IDENTITY_ROW).all(axis=(1, 2))
    table.neg_a_rows = torch.as_tensor(rows, device=table.device)
    if window_tables is not None:
        wt = np.ascontiguousarray(window_tables).astype(np.int16)
        if wt.shape != (v * 1024, 4, _N_LIMBS):
            raise ValueError(f"window_tables must be [{v * 1024}, 4, 20], got {wt.shape}")
        table._window_tables = torch.as_tensor(wt, device=table.device)
    if v > PubkeyTable.TABULATED_MAX_VALIDATORS:
        table.tabulated = False
    return table


class TableCache:
    """Per-validator-set device tables for indexed commit verification.

    verify_commit knows (validator-set key, row indices); routing through
    this cache lets commit verification gather pubkey rows (and, tabulated,
    window tables) on the device instead of shipping pubkeys every call.
    Keyed by the set's pubkey digest; small LRU.  Tables build synchronously
    on a miss.  Installed process-wide via `install()`."""

    def __init__(
        self,
        verifier: Optional[BatchVerifier] = None,
        max_sets: int = 4,
        tabulated: Optional[bool] = None,
        device=None,
    ):
        self.verifier = verifier or BatchVerifier(device=device)
        self.max_sets = max_sets
        self.tabulated = tabulated
        self._tables: "collections.OrderedDict[bytes, PubkeyTable]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def table_for(self, set_key: bytes, pubkeys: Sequence[bytes]) -> PubkeyTable:
        """Get or build the table for a validator set."""
        with self._lock:
            tab = self._tables.get(set_key)
            if tab is not None:
                self._tables.move_to_end(set_key)
                return tab
        tab = PubkeyTable(pubkeys, verifier=self.verifier, tabulated=self.tabulated)
        if tab.tabulated:
            tab.build_tables()
        with self._lock:
            self._tables[set_key] = tab
            if len(self._tables) > self.max_sets:
                self._tables.popitem(last=False)
        return tab

    def verify_indexed(
        self,
        set_key: bytes,
        pubkeys,
        idxs: Sequence[int],
        msgs: Sequence[bytes],
        sigs: Sequence[bytes],
    ) -> Optional[List[bool]]:
        """`pubkeys` is the set's rows or a thunk returning them (only a
        cache miss materializes them)."""
        with self._lock:
            tab = self._tables.get(set_key)
            if tab is not None:
                self._tables.move_to_end(set_key)
        if tab is None:
            tab = self.table_for(set_key, pubkeys() if callable(pubkeys) else pubkeys)
        return tab.verify_indexed(idxs, msgs, sigs)

    def has_table(self, set_key: bytes) -> bool:
        with self._lock:
            return set_key in self._tables

    def install(self) -> "TableCache":
        batch_hook.set_indexed_verifier(self.verify_indexed)
        return self
