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

A CUDA kernel takes any batch size, so on one card batches are not padded
to buckets and nothing is compiled per shape: the JAX package's per-bucket
compile warmup becomes one background build of the kernel library.  Every
entry point takes `device`: None means "cuda", and without a card it raises
unless the caller passes device="cpu", where the wrappers run their plain
torch versions.

With a `mesh` (crypto/backend.py `Mesh`, from `resolve_mesh`) the batch is
sharded as the JAX package shards it: padded to JAX's bucket (a multiple of
the shard count), split into one contiguous slice per shard, the pubkey
rows replicated on every device of the mesh, kernel 1 launched once per
shard on the shard's own stream before any verdict is read back, the
verdicts gathered through non-blocking copies and events.  One device is
a mesh of one shard, on the same path, with no padding.  A shard whose
launch fails raises; nothing is served by the host or by fewer shards.

Vote ingress: AsyncBatchVerifier coalesces single checks (verify_one),
pre-batched relay frames (verify_direct) and whole batches (verify_many)
onto BatchVerifier.verify on a one-worker executor.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import logging
import math
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..libs import tracing
from ..libs.metrics import VerifyMetrics
from ..libs.service import Service
from ..ops import _build, _check
from . import batch as batch_hook
from . import ed25519_math as em
from .backend import Mesh

logger = logging.getLogger(__name__)

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


def _pad_rows(b: int, *arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Each array zero-padded along its first axis to b rows."""
    return tuple(
        a if a.shape[0] >= b else np.concatenate([a, np.zeros((b - a.shape[0],) + a.shape[1:], a.dtype)])
        for a in arrays
    )


def _staged(a: np.ndarray, card: bool) -> torch.Tensor:
    """A host array as a tensor, in pinned memory when it goes to a card:
    then its uploads are asynchronous, and every shard's launch is queued
    without waiting for the copies of the shards after it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if card else t


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


@contextlib.contextmanager
def _engine_call(what: str):
    """Device work of the engine: whatever it raises is the engine's fault
    (crypto.batch.EngineError), never the input's, whose checks all run on
    the host before it."""
    try:
        yield
    except batch_hook.EngineError:
        raise
    except Exception as e:
        raise batch_hook.EngineError(f"{what} failed in the engine: {e!r}") from e


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------

_CHUNK = 2048  # chunk of the double-buffered single shot (PubkeyTable._verify_chunked)
_MIN_BUCKET = 16


def _bucket_size(n: int, multiple_of: int = 1) -> int:
    """The JAX package's power-of-two bucket (at least 16), rounded up to a
    multiple of `multiple_of`."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    if b % multiple_of:
        b = ((b + multiple_of - 1) // multiple_of) * multiple_of
    return b


class BatchVerifier:
    """Batched ed25519 verification of per-call (pubkey, msg, sig) triples
    on kernel 1.

    `min_device_batch` is a routing rule: batches smaller than it verify on
    the serial host path (crypto.batch.host_batch_verify).  1 = always the
    device.  Every dispatch is recorded as a `verify.dispatch` event on
    `recorder` (and kept in `last_dispatch`), with the JAX package's fields;
    `metrics` gets the same observations as there.  `chunk_size` (0 = the
    module's _CHUNK) and `chunk_depth` shape PubkeyTable's chunked single
    shot.

    `mesh` (None: one device) shards every device batch over the mesh's
    devices (see the module docstring); the mesh's first device is the
    verifier's `device`, where unsharded work runs, and a `device` the
    caller names must be that one.  `shards` is the shard count, stamped on
    every `verify.*` event."""

    # min_device_batch values past this can never be reached by a real
    # batch: the engine routes everything to the host, and start_warmup
    # builds nothing.
    _NEVER_DEVICE = 1 << 16

    def __init__(
        self,
        device=None,
        min_device_batch: int = 1,
        metrics: Optional[VerifyMetrics] = None,
        recorder=None,
        chunk_size: int = 0,
        chunk_depth: int = 2,
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device if mesh is None else mesh.lead(device))
        self.mesh = mesh
        # the devices the ladder runs on: the mesh, or a mesh of the one
        # device (whose own stream serves every dispatch)
        self._shards = mesh or Mesh([self.device])
        self.min_device_batch = min_device_batch
        self.shards = self._shards.size
        self.chunk_size = chunk_size
        self.chunk_depth = chunk_depth
        self.metrics = metrics if metrics is not None else VerifyMetrics()
        self.recorder = recorder if recorder is not None else tracing.NOP
        self.last_dispatch: Dict[str, object] = {}
        # Cold start.  On the card the device path needs the kernel library,
        # which nvcc builds at first use (ops/_build.py, ~10 s).  In warmup
        # mode (start_warmup) the build runs on a background thread and
        # verify() serves the host path, path="host-cold", only while it is
        # in flight.  A failed build is kept and raised by every later
        # device-routed verify(): unlike the JAX package, which leaves a
        # bucket whose compile failed on the host path for good, the port
        # never lets a broken kernel hide behind the host.
        self._needs_library = self.device.type == "cuda"
        self._warmup_mode = False
        self._building = False
        self._build_error: Optional[Exception] = None
        self._warm_lock = threading.Lock()
        # host<->device dispatch RTT probe (run at install; drives the
        # chunked single shot's auto choice).  None until probed.
        self.rtt_probe: Optional[Dict[str, float]] = None

    def _dispatch(self, **fields) -> None:
        fields["shards"] = self.shards
        self.last_dispatch = fields
        self.recorder.record("verify.dispatch", **fields)

    # -- cold start --------------------------------------------------------

    def _library_state(self, n: int) -> str:
        """"ready", "building" or "failed" for a device-routed batch of n.
        Outside warmup mode, on the CPU, or once the library is loaded:
        ready (a missing library then builds inline at the first launch).
        Otherwise starts the background build if none has run."""
        if not self._warmup_mode or not self._needs_library or _build.loaded():
            return "ready"
        with self._warm_lock:
            if self._build_error is not None:
                return "failed"
            if self._building:
                return "building"
            self._building = True
        # non-daemon: interpreter exit waits for nvcc instead of killing the
        # build half-way through writing the library
        threading.Thread(target=self._build_library, args=(n,), daemon=False,
                         name="bv-warmup").start()
        return "building"

    def _build_library(self, n: int) -> None:
        t0 = time.perf_counter()
        error = None
        try:
            _build.lib()
            self._warm_devices()
        except Exception as e:  # kept, and raised by the next device-routed verify
            logger.exception("CUDA kernel library build failed")
            error = e
        with self._warm_lock:
            self._building = False
            self._build_error = error
        self.metrics.bucket_compiles.inc()
        self.recorder.record("verify.bucket_compile", bucket=n, ms=round(_ms_since(t0), 3),
                             ok=error is None, shards=self.shards)

    def _warm_devices(self) -> None:
        """Load the kernel library on every card of the mesh (or the one
        card): each card's context, its copy of kernel 1's base table, its
        kernel module (an occupancy query loads it there) and the shards'
        streams, so no shard's first dispatch pays a first use.  The
        counterpart of JAX compiling the sharded bucket at warmup."""
        from ..ops import ed25519_cuda

        for dev in self._shards.distinct():
            if dev.type != "cuda":
                continue
            with torch.cuda.device(dev):
                _check.device_const(ed25519_cuda.BASE_TABLE, dev)
                if _build.lib().ed25519_ladder_resident_warps() < 0:
                    raise RuntimeError(f"kernel 1 did not load on {dev}")
        self._shards.streams()

    def start_warmup(self) -> "BatchVerifier":
        """Enable cold-start routing and start building the kernel library
        in the background (nothing to build on the CPU or when
        min_device_batch keeps every batch on the host); a library already
        loaded is warmed on every card of the mesh here."""
        self._warmup_mode = True
        if self.min_device_batch < self._NEVER_DEVICE:
            if self._needs_library and _build.loaded():
                self._warm_devices()
            self._library_state(max(1, self.min_device_batch))
        return self

    def rewarm(self, n: int) -> None:
        """Warm for an expected batch of n (a validator-set size change).
        A CUDA kernel takes any batch size, so past the library build there
        is nothing to warm: this only starts the build where none has run."""
        if not self._warmup_mode or self.min_device_batch >= self._NEVER_DEVICE:
            return
        if n < self.min_device_batch:
            return
        self._library_state(n)

    # -- chunked single shot: RTT probe ------------------------------------

    def probe_dispatch_rtt(self, samples: int = 7) -> Dict[str, float]:
        """What one extra device dispatch costs against what one chunk of
        host prep takes, to decide whether the chunked single shot pays
        (PubkeyTable.chunked_single_shot).

        - dispatch_rtt_ms: min round trip of a tiny device op and the fetch
          of its result;
        - prep_ms_per_chunk: host prep of one chunk of signatures, from a
          512-signature synthetic batch (what overlap can hide per extra
          dispatch).

        Chunking is selected iff dispatch_rtt_ms < prep_ms_per_chunk.
        Cached after the first call."""
        if self.rtt_probe is not None:
            return self.rtt_probe
        x = torch.zeros(8, dtype=torch.int32, device=self.device)
        (x + 1).cpu()  # first-use allocation outside the timed loop
        rtts = []
        for _ in range(samples):
            t0 = time.perf_counter()
            (x + 1).cpu()
            rtts.append(time.perf_counter() - t0)
        rtt_ms = min(rtts) * 1000
        probe_n = 512
        items = [(bytes(32), b"\x08\x02\x11" + bytes(100), bytes(64)) for _ in range(probe_n)]
        _scalar_rows(items)  # warm allocators and the C library
        t0 = time.perf_counter()
        _scalar_rows(items)
        prep_ms_per_chunk = _ms_since(t0) / probe_n * self.effective_chunk()
        self.rtt_probe = {
            "dispatch_rtt_ms": rtt_ms,
            "prep_ms_per_chunk": prep_ms_per_chunk,
            "chunked_selected": float(rtt_ms < prep_ms_per_chunk),
        }
        self.recorder.record(
            "verify.chunked",
            selected=bool(rtt_ms < prep_ms_per_chunk),
            rtt_ms=round(rtt_ms, 4),
            prep_ms=round(prep_ms_per_chunk, 4),
            shards=self.shards,
        )
        return self.rtt_probe

    def effective_chunk(self) -> int:
        """Chunk size of the chunked single shot: the configured size or
        the module default, rounded up so that each chunk splits evenly
        over the mesh."""
        cs = self.chunk_size or _CHUNK
        m = self.shards
        return ((cs + m - 1) // m) * m

    def _bucket(self, n: int) -> int:
        """Rows a device batch of n signatures is padded to.  One device:
        n (a kernel takes any size).  Under a mesh, the JAX package's XLA
        bucket: a power of two (at least 16) rounded to a multiple of the
        shard count up to 2,048, then multiples of lcm(1024, shards)."""
        if self.mesh is None:
            return n
        m = self.shards
        if n <= 2048:
            return _bucket_size(n, m)
        step = 1024 * m // math.gcd(1024, m)
        return ((n + step - 1) // step) * step

    def _sharded(self, rows_of, idx, h_digits, s_digits, r_y, r_sign) -> np.ndarray:
        """Kernel 1 on every shard (one on one device).  The per-signature
        host arrays have the padded bucket's rows; shard k verifies its k-th
        contiguous slice against `rows_of(k, device)`, on its own stream.
        The inputs go up from pinned memory without blocking the host, and
        every shard's launch is queued before any verdict is read: each
        shard's verdicts come back by a non-blocking copy into pinned host
        memory and an event on its stream, which the gather waits for."""
        from ..ops import ed25519_cuda

        mesh = self._shards
        b = len(idx)
        q = b // mesh.size
        card = self.device.type == "cuda"
        host = [_staged(a, card) for a in (
            idx.astype(np.int32), _pack_digits(h_digits), _pack_digits(s_digits),
            r_y.astype(np.int16), r_sign.astype(np.uint8))]
        launched = []
        for k, dev in enumerate(mesh.devices):
            with mesh.on_shard(k) as stream:
                args = [t[k * q:(k + 1) * q].to(dev, non_blocking=True) for t in host]
                ok = ed25519_cuda.verify_indexed(rows_of(k, dev), *args)
                if stream is None:
                    launched.append((ok, None))
                    continue
                verdicts = torch.empty(q, dtype=torch.bool, pin_memory=True)
                verdicts.copy_(ok, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
                launched.append((verdicts, done))
        out = np.empty(b, dtype=bool)
        for k, (verdicts, done) in enumerate(launched):
            if done is not None:
                done.synchronize()
            out[k * q:(k + 1) * q] = verdicts.numpy()
        return out

    def chunked_auto(self) -> bool:
        """True when the RTT probe says the chunked single shot pays."""
        try:
            return bool(self.probe_dispatch_rtt()["chunked_selected"])
        except Exception:
            logger.exception("dispatch RTT probe failed; keeping the monolithic path")
            return False

    # -- verify --------------------------------------------------------------

    def verify(
        self, pubkeys: Sequence[bytes], msgs: Sequence[bytes], sigs: Sequence[bytes]
    ) -> List[bool]:
        n = len(sigs)
        if n == 0:
            return []
        self.metrics.batch_size.observe(n)
        if n < self.min_device_batch:
            t0 = time.perf_counter()
            out = batch_hook.host_batch_verify(pubkeys, msgs, sigs)
            self._dispatch(n=n, bucket=0, path="host", host_prep_ms=0.0,
                           device_ms=round(_ms_since(t0), 3))
            return out
        state = self._library_state(n)
        if state == "failed":
            raise batch_hook.EngineError(
                "the CUDA kernel library failed to build; device-routed batches "
                f"are not served from the host: {self._build_error!r}"
            ) from self._build_error
        if state == "building":
            self._dispatch(n=n, bucket=self._bucket(n), path="host-cold", host_prep_ms=0.0,
                           device_ms=0.0)
            return batch_hook.host_batch_verify(pubkeys, msgs, sigs)
        t0 = time.perf_counter()
        neg_a, h_digits, s_digits, r_y, r_sign, valid = prepare_batch(pubkeys, msgs, sigs)
        prep_s = time.perf_counter() - t0
        self.metrics.host_prep_seconds.observe(prep_s)
        if not valid.any():
            return [False] * n
        b = self._bucket(n)
        t1 = time.perf_counter()
        # padding rows (under a mesh) repeat the last pubkey row (JAX's
        # rule); their scalars are zero and their verdicts are dropped
        if b > n:
            neg_a = np.concatenate([neg_a, np.repeat(neg_a[-1:], b - n, axis=0)])
        h_digits, s_digits, r_y, r_sign = _pad_rows(b, h_digits, s_digits, r_y, r_sign)
        q = b // self.shards
        with _engine_call("ladder"):
            rows = _staged(neg_a, self.device.type == "cuda")
            ok = self._sharded(
                lambda k, dev: rows[k * q:(k + 1) * q].to(dev, non_blocking=True),
                np.arange(b) % q, h_digits, s_digits, r_y, r_sign,
            )[:n]
        dev_s = time.perf_counter() - t1
        self.metrics.device_seconds.observe(dev_s)
        self._dispatch(n=n, bucket=b, path="device", host_prep_ms=round(prep_s * 1000, 3),
                       device_ms=round(dev_s * 1000, 3))
        return np.logical_and(ok, valid).tolist()

    def install(self) -> "BatchVerifier":
        """Become the process-wide batch-verify hook used by
        ValidatorSet.verify_commit* when no indexed hook serves, and start
        the dispatch RTT probe in the background, so the chunked single
        shot's choice is made before the first large batch arrives."""
        batch_hook.set_verifier(self.verify)
        threading.Thread(target=self.chunked_auto, daemon=False, name="bv-rtt-probe").start()
        return self


# One break-even profile per process and card: does the tabulated
# zero-doubling kernel beat the ladder at commit shapes?  See
# PubkeyTable._auto_tabulated.
_tabulated_verdict: Dict[str, bool] = {}
tabulated_profiles: Dict[str, Dict[str, float]] = {}
_tabulated_lock = threading.Lock()


def invalidate_tabulated_profile() -> None:
    """Drop the cached tabulated-vs-ladder verdicts.  The profile is timed
    at the live commit size, so a validator-set size change can flip the
    break-even: TableCache.rebuild calls this when the set size changes and
    the next table to resolve AUTO profiles again."""
    with _tabulated_lock:
        _tabulated_verdict.clear()


def _event_ms(fn, stream) -> float:
    """Device ms of what one call of fn launches on `stream`, by CUDA events
    (the kernels' own clock)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end)


class _ChunkSlot:
    """One slot of the chunked single shot's ring: host buffers for one
    chunk's kernel inputs and verdicts, pinned on the card so both copies
    run asynchronously, and the event recorded after the verdict copy.
    A slot is refilled, and its verdicts read, only after that event."""

    def __init__(self, cs: int, card: bool):
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=card)

        self.inputs = (
            buf(cs, torch.int32),  # idx
            buf((cs, 32), torch.uint8),  # h, packed
            buf((cs, 32), torch.uint8),  # s, packed
            buf((cs, _N_LIMBS), torch.int16),  # r_y
            buf(cs, torch.uint8),  # r_sign
        )
        self.ok = buf(cs, torch.bool)
        self.done = torch.cuda.Event() if card else None

    def fill(self, cnt: int, *arrays: np.ndarray) -> None:
        for t, a in zip(self.inputs, arrays):
            t.numpy()[:cnt] = a

    def verdicts(self, cnt: int) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.ok.numpy()[:cnt]


class PubkeyTable:
    """Device-resident decompressed validator pubkey table, keyed by
    validator index — commits verify by gathering rows inside the kernel.
    Rebuilt only on validator-set changes.

    `tabulated=True` additionally builds per-validator window tables
    (kernel 2) so commit verification needs zero point doublings (kernel 3).
    `tabulated=None` (the default) is AUTO: a one-time per-process profile
    times both kernels at the live commit size on this card and engages the
    tables only where they win.  On the CPU (plain versions) auto means
    off.

    `chunked_single_shot` splits a large ladder batch into chunks whose
    host prep overlaps the device's work on the previous ones
    (_verify_chunked).  None (the default) is AUTO: the verifier's RTT
    probe decides.  True/False force it either way.

    Under the verifier's mesh the rows are replicated on every device of
    the mesh, and the ladder paths are sharded with a shard-local gather:
    each shard gathers from its own device's copy.  AUTO tabulated is off
    there (the JAX package's rule); a forced `tabulated=True` runs
    unsharded on the mesh's first device."""

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
        self._shards = self.verifier._shards
        self._set_rows(rows)
        self._window_tables: Optional[torch.Tensor] = None
        if n > self.TABULATED_MAX_VALIDATORS:
            tabulated = False
        self.tabulated = tabulated
        self.chunked_single_shot: Optional[bool] = None

    def _set_rows(self, rows: np.ndarray) -> None:
        """The [V, 4, 20] −A rows on every device of the shards, once per
        device; `neg_a_rows` is the first device's copy."""
        self._replicas = {d: torch.as_tensor(rows, device=d) for d in self._shards.distinct()}
        self.neg_a_rows = self._replicas[self._shards.devices[0]]

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
        cached per card name for the process.  Off under a mesh, where the
        sharded ladder serves (the JAX package's rule)."""
        if self.device.type != "cuda" or self.verifier.mesh is not None:
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
        win = tab_ms < ladder_ms
        self.verifier.recorder.record(
            "verify.tabulated_profile",
            engaged=win,
            tab_ms=round(tab_ms, 3),
            ladder_ms=round(ladder_ms, 3),
            table_build_ms=round(build_ms, 3),
            bucket=n,
            validators=len(self.pubkeys),
        )
        if not win:
            self._window_tables = None  # the ladder serves: free 160 KB per validator
        return win

    def verify_indexed(
        self, idxs: Sequence[int], msgs: Sequence[bytes], sigs: Sequence[bytes]
    ) -> List[bool]:
        """Verify msgs[i]/sigs[i] against table row idxs[i]."""
        from ..ops import ed25519_table

        n = len(sigs)
        if n == 0:
            return []
        pk_count = len(self.pubkeys)
        self.verifier.metrics.batch_size.observe(n)
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
        idx_arr = np.clip(idx_arr, 0, max(pk_count - 1, 0))

        with _engine_call("tabulated profile"):
            tab = self._tabulated_active(n)

        cs = self.verifier.effective_chunk()
        use_chunked = self.chunked_single_shot
        chunk_eligible = not tab and n >= 2 * cs
        if use_chunked is None and chunk_eligible:
            use_chunked = self.verifier.chunked_auto()
        if use_chunked and chunk_eligible:
            return self._verify_chunked(items, idx_arr, cs)

        t0 = time.perf_counter()
        h_digits, s_digits, r_y, r_sign, valid = _scalar_rows(items)
        prep_s = time.perf_counter() - t0
        self.verifier.metrics.host_prep_seconds.observe(prep_s)
        if not valid.any():
            return [False] * n
        b = n if tab else self.verifier._bucket(n)
        t1 = time.perf_counter()
        if tab:
            with _engine_call("tabulated sum"):
                args = _device_rows(self.device, idx_arr, h_digits, s_digits, r_y, r_sign)
                ok = ed25519_table.verify_tabulated(self.build_tables(), *args).cpu().numpy()
        else:
            idx_arr, h_digits, s_digits, r_y, r_sign = _pad_rows(
                b, idx_arr, h_digits, s_digits, r_y, r_sign)
            with _engine_call("indexed ladder"):
                ok = self.verifier._sharded(lambda k, dev: self._replicas[dev],
                                            idx_arr, h_digits, s_digits, r_y, r_sign)[:n]
        dev_s = time.perf_counter() - t1
        self.verifier.metrics.device_seconds.observe(dev_s)
        self.verifier._dispatch(
            n=n, bucket=b, path="tabulated" if tab else "indexed",
            host_prep_ms=round(prep_s * 1000, 3), device_ms=round(dev_s * 1000, 3),
        )
        return np.logical_and(ok, valid).tolist()

    def _verify_chunked(self, items: list, idx_arr: np.ndarray, cs: int) -> List[bool]:
        """Double-buffered single shot on the ladder: chunk k+1's host prep
        runs while the card verifies chunk k, so a large batch costs about
        prep(one chunk) + device(all) instead of prep(all) + device(all).

        Each shard (the one device, or every shard of the mesh) has its own
        CUDA stream and its own ring of chunk_depth slots of pinned host
        buffers: inputs go H2D and verdicts D2H without blocking the host,
        and an event recorded after the verdict copy gates both the slot's
        refill and the reading of its verdicts.  Under a mesh every chunk is
        padded to cs rows (the JAX package's chunk) and split into one
        contiguous slice per shard.  On CPU tensors the same loop runs with
        plain buffers and no stream."""
        from ..ops import ed25519_cuda

        n = len(items)
        shards = self._shards
        sharded = self.verifier.mesh is not None
        card = self.device.type == "cuda"
        n_chunks = (n + cs - 1) // cs
        depth = min(max(1, self.verifier.chunk_depth), n_chunks)
        width = cs // shards.size  # rows a shard verifies of a chunk
        with _engine_call("chunked ladder"):
            rings = [[_ChunkSlot(width, card) for _ in range(depth)] for _ in shards.devices]
        pending: "collections.deque" = collections.deque()
        out: List[bool] = []

        def collect():
            slots, w, cnt, valid_c = pending.popleft()
            with _engine_call("chunked ladder"):
                verdicts = np.concatenate([slot.verdicts(w) for slot in slots])[:cnt]
            out.extend(np.logical_and(verdicts, valid_c).tolist())

        t0 = time.perf_counter()
        for k, start in enumerate(range(0, n, cs)):
            end = min(start + cs, n)
            cnt = end - start
            h, s, ry, rs, valid_c = _scalar_rows(items[start:end])
            arrays = (idx_arr[start:end], _pack_digits(h), _pack_digits(s), ry, rs)
            w = cnt
            if sharded:
                arrays, w = _pad_rows(cs, *arrays), width
            # the oldest chunk in flight holds the slots this one refills
            while len(pending) >= depth:
                collect()
            slots = [ring[k % depth] for ring in rings]
            for j, slot in enumerate(slots):
                slot.fill(w, *(a[j * w:(j + 1) * w] for a in arrays))
                dev = shards.devices[j]
                with _engine_call("chunked ladder"), shards.on_shard(j) as stream:
                    args = [t[:w].to(dev, non_blocking=True) for t in slot.inputs]
                    ok = ed25519_cuda.verify_indexed(self._replicas[dev], *args)
                    slot.ok[:w].copy_(ok, non_blocking=True)
                    if stream is not None:
                        slot.done.record(stream)
            pending.append((slots, w, cnt, valid_c))
        while pending:
            collect()
        # prep and device time interleave by design: the overlapped wall
        # time is reported as device_ms
        self.verifier._dispatch(n=n, bucket=cs, path="chunked", host_prep_ms=0.0,
                                device_ms=round(_ms_since(t0), 3))
        return out


def from_jax_state(
    neg_a_rows: np.ndarray, window_tables: Optional[np.ndarray], device=None, mesh=None
) -> PubkeyTable:
    """A PubkeyTable whose device state is the JAX package's arrays: the
    [V, 4, 20] −A rows (PubkeyTable.neg_a_rows; under a JAX mesh they are
    replicated, so any device's copy is the whole table) and, optionally,
    the [V*1024, 4, 20] int16 window tables (build_window_tables).  Given
    tables, the table serves tabulated; without, it decides as AUTO.  With
    `mesh` the table's verifier shards over it and the rows are replicated
    on each of its devices.

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
    table = PubkeyTable([], verifier=BatchVerifier(device=device, mesh=mesh),
                        tabulated=True if window_tables is not None else None)
    table.pubkeys = pubkeys
    table.row_valid = ~(rows == IDENTITY_ROW).all(axis=(1, 2))
    table._set_rows(rows)
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
    Keyed by the set's pubkey digest; small LRU.  Installed process-wide
    via `install()`.

    Outside warmup mode a miss builds the table synchronously.  In warmup
    mode (the node's: BatchVerifier.start_warmup) a miss builds it on a
    background thread and declines (returns None) meanwhile, so the caller
    falls back to the flat batch verifier instead of stalling on the build;
    `rebuild` builds a set's table before its first commit arrives."""

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
        self._building: set = set()
        self._lock = threading.Lock()

    def table_for(self, set_key: bytes, pubkeys: Sequence[bytes]) -> PubkeyTable:
        """Get or build (synchronously) the table for a validator set."""
        with self._lock:
            tab = self._tables.get(set_key)
            if tab is not None:
                self._tables.move_to_end(set_key)
                return tab
        with _engine_call("table build"):
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
        cache miss materializes them).  None: declined while the set's
        table builds in the background."""
        with self._lock:
            tab = self._tables.get(set_key)
            if tab is not None:
                self._tables.move_to_end(set_key)
        metrics, recorder = self.verifier.metrics, self.verifier.recorder
        if tab is not None:
            metrics.table_cache_hits.inc()
            recorder.record("verify.table", hit=True, n=len(sigs))
            return tab.verify_indexed(idxs, msgs, sigs)
        metrics.table_cache_misses.inc()
        recorder.record("verify.table", hit=False, n=len(sigs))
        if not self.verifier._warmup_mode:
            return self.table_for(set_key, self._rows(pubkeys)).verify_indexed(idxs, msgs, sigs)
        with self._lock:
            if set_key in self._building:
                return None
            self._building.add(set_key)
        pk_copy = [bytes(pk) for pk in self._rows(pubkeys)]
        n_hint = max(len(sigs), 1)

        def build():
            try:
                tab = self.table_for(set_key, pk_copy)
                # warm the dispatch at this commit's size, so the first
                # verify after the build does not pay the AUTO profile
                tab.verify_indexed(
                    [i % max(len(pk_copy), 1) for i in range(n_hint)],
                    [b"warmup"] * n_hint,
                    [bytes(64)] * n_hint,
                )
            except Exception:  # the next miss tries again; the flat path serves meanwhile
                logger.exception("background table build failed")
            finally:
                with self._lock:
                    self._building.discard(set_key)

        # non-daemon: interpreter exit waits for the build's device work
        threading.Thread(target=build, daemon=False, name="table-build").start()
        return None

    @staticmethod
    def _rows(pubkeys) -> Sequence[bytes]:
        """Materialized rows, or the result of a lazy thunk."""
        return pubkeys() if callable(pubkeys) else pubkeys

    def has_table(self, set_key: bytes) -> bool:
        with self._lock:
            return set_key in self._tables

    def rebuild(self, set_key: bytes, pubkeys) -> bool:
        """Build the table for a validator set in the background, before
        its first commit arrives (the node calls this when a validator-set
        update lands), and warm the dispatch at the whole-commit shape (one
        row per validator).  When the set size differs from every cached
        set's, the tabulated break-even profile is dropped first, since it
        was timed at another size.

        Returns True when a build was started; False when the set's table
        is already cached or building."""
        pk_copy = [bytes(pk) for pk in self._rows(pubkeys)]
        n = len(pk_copy)
        with self._lock:
            known_sizes = {len(tab.pubkeys) for tab in self._tables.values()}
            if set_key in self._tables or set_key in self._building:
                self.verifier.rewarm(n)
                return False
            self._building.add(set_key)
        if known_sizes and n not in known_sizes:
            invalidate_tabulated_profile()
        self.verifier.rewarm(n)
        t0 = time.perf_counter()

        def build():
            ok = False
            try:
                tab = self.table_for(set_key, pk_copy)
                tab.verify_indexed(list(range(n)), [b"warmup"] * n, [bytes(64)] * n)
                ok = True
            except Exception:  # recorded with ok=False
                logger.exception("table rebuild failed")
            finally:
                with self._lock:
                    self._building.discard(set_key)
            self.verifier.metrics.table_rebuilds.inc()
            self.verifier.recorder.record(
                "verify.table_rebuild",
                set_key=set_key.hex()[:16],
                validators=n,
                ms=round(_ms_since(t0), 3),
                ok=ok,
                shards=self.verifier.shards,
            )

        threading.Thread(target=build, daemon=False, name="table-rebuild").start()
        return True

    def install(self) -> "TableCache":
        batch_hook.set_indexed_verifier(self.verify_indexed)
        return self


# ---------------------------------------------------------------------------
# async batcher: trickling votes coalesce into device batches
# ---------------------------------------------------------------------------


class AsyncBatchVerifier(Service):
    """Deadline-flushed batcher.

    Callers enqueue single (pubkey, msg, sig) checks and await a future; a
    flusher coalesces the queue into one BatchVerifier call on a
    one-worker executor, so device work never runs on the event loop and
    stays serialized.

    The window adapts to the arrival rate: while recent inter-arrival gaps
    say more votes are imminent it keeps coalescing up to `flush_interval`;
    when the queue goes quiet it flushes after `flush_min`.  Batches are cut
    at `max_batch`; past `max_pending` queued checks, new ones verify on
    the host path instead of queueing.  `adaptive=False` flushes on a fixed
    `flush_interval`.  Defaults are the node's ([tpu] config).  Futures and
    the executor belong to the running loop: call the methods from it."""

    def __init__(
        self,
        verifier: Optional[BatchVerifier] = None,
        max_batch: int = 4096,
        flush_interval: float = 0.002,
        max_pending: int = 65536,
        flush_min: float = 0.0002,
        adaptive: bool = True,
    ):
        super().__init__("batch-verifier")
        self.verifier = verifier or BatchVerifier()
        self.max_batch = max_batch
        self.flush_interval = flush_interval
        self.flush_min = min(flush_min, flush_interval)
        self.adaptive = adaptive
        self.max_pending = max_pending
        # (pubkey, msg, sig, fut, t_enqueued): the timestamp feeds the
        # queue-wait histogram and the recorder's flush events
        self._pending: List[Tuple[bytes, bytes, bytes, asyncio.Future, float]] = []
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        # EWMA of the enqueue inter-arrival gap (seconds); None until 2 arrivals
        self._ewma_gap: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._enqueued = 0  # monotonic count, detects arrivals per window

    async def on_start(self) -> None:
        self._wake = asyncio.Event()
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="bv-flush")
        self.verifier.start_warmup()  # builds on its own thread; host path until built
        self._task = self.spawn(self._flush_loop(), "flush-loop")

    async def on_stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        for _, _, _, fut, _ in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        if self._executor is not None:
            self._executor.shutdown(wait=False)

    def _note_arrival(self, now: float, accepted: int) -> None:
        """Shared enqueue bookkeeping: one arrival-rate sample per call (a
        batch of N simultaneous entries must not convince the EWMA that
        votes arrive at nanosecond gaps), the arrivals counter the adaptive
        flusher watches, and the wake."""
        if self._last_arrival is not None:
            # one-sided clamp: one long idle period must not poison the
            # estimate for the next burst
            gap = min(now - self._last_arrival, self.flush_interval)
            self._ewma_gap = gap if self._ewma_gap is None else 0.8 * self._ewma_gap + 0.2 * gap
        self._last_arrival = now
        self._enqueued += accepted
        if self._wake and (self.adaptive or len(self._pending) >= self.max_batch):
            self._wake.set()

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> "asyncio.Future[bool]":
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if len(self._pending) >= self.max_pending:
            # backpressure: past the cap verify inline on the host path;
            # slower per signature, but bounded memory and no dropped-vote
            # false negatives
            ok = batch_hook.host_batch_verify([pubkey], [msg], [sig])[0]
            fut.set_result(bool(ok))
            return fut
        now = loop.time()
        self._pending.append((pubkey, msg, sig, fut, now))
        self.verifier.recorder.record("verify.enqueue", pending=len(self._pending))
        self._note_arrival(now, accepted=1)
        return fut

    async def verify_direct(self, items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
        """One pre-batched engine call on the flush executor, bypassing the
        coalescing flusher: a relay frame already has a batch's shape.  The
        single executor worker keeps it serialized with regular flushes."""
        if not items:
            return []
        pubkeys = [it[0] for it in items]
        msgs = [it[1] for it in items]
        sigs = [it[2] for it in items]
        loop = asyncio.get_running_loop()
        self.verifier.recorder.record("verify.direct_batch", n=len(items))
        return await loop.run_in_executor(self._executor, self.verifier.verify, pubkeys, msgs, sigs)

    async def verify_bls_aggregates(
        self, items: Sequence[Tuple[Sequence[bytes], bytes, bytes]]
    ) -> List[bool]:
        """BLS aggregate-commit lane: each item is a FastAggregateVerify
        claim (pubkeys, msg, aggregate_sig).  The whole batch runs as ONE
        blinded pairing product (crypto/bls/scheme.batch_verify_aggregates)
        on the flush executor, serialized with the card's work and never on
        the event loop.  The scheme memoizes the results, so the synchronous
        verify_commit that follows a pre-verify lane (state sync, lite2,
        fast sync) hits the memo instead of pairing again."""
        if not items:
            return []
        from .bls import scheme as _bls_scheme

        loop = asyncio.get_running_loop()
        t0 = loop.time()
        self.verifier.recorder.record(
            "verify.bls_agg", n=len(items), tier=_bls_scheme.active_tier()
        )
        if self._executor is not None:
            res = await loop.run_in_executor(
                self._executor, _bls_scheme.batch_verify_aggregates, list(items)
            )
        else:
            res = _bls_scheme.batch_verify_aggregates(list(items))
        m = self.verifier.metrics
        m.bls_agg_seconds.observe(loop.time() - t0)
        for _ in items:
            m.bls_agg_checks.inc()
        return res

    def verify_many(
        self, items: Sequence[Tuple[bytes, bytes, bytes]]
    ) -> List["asyncio.Future[bool]"]:
        """Enqueue a whole batch of (pubkey, msg, sig) checks as one
        arrival: everything is appended before the flusher wakes, so the
        batch reaches the device as one flush instead of vote by vote.
        Returns one future per item, in order."""
        loop = asyncio.get_running_loop()
        futs: List[asyncio.Future] = []
        overflow: List[Tuple[bytes, bytes, bytes, asyncio.Future]] = []
        now = loop.time()
        accepted = 0
        for pubkey, msg, sig in items:
            fut: asyncio.Future = loop.create_future()
            futs.append(fut)
            if len(self._pending) >= self.max_pending:
                overflow.append((pubkey, msg, sig, fut))
                continue
            self._pending.append((pubkey, msg, sig, fut, now))
            accepted += 1
        if items:
            self.verifier.recorder.record(
                "verify.enqueue_batch", n=len(items), pending=len(self._pending)
            )
            self._note_arrival(now, accepted)
        if overflow:
            # verify_one's backpressure contract (past the cap: host path,
            # never drop), but a whole batch of overflow runs on the flush
            # executor while the service runs, not inline on the loop
            pks = [o[0] for o in overflow]
            over_msgs = [o[1] for o in overflow]
            over_sigs = [o[2] for o in overflow]
            if self._executor is not None:
                ex_fut = loop.run_in_executor(
                    self._executor, batch_hook.host_batch_verify, pks, over_msgs, over_sigs
                )

                def deliver(done_fut, overflow=overflow):
                    try:
                        results = done_fut.result()
                    except Exception as e:
                        for _, _, _, fut in overflow:
                            if not fut.done():
                                fut.set_exception(RuntimeError(f"overflow verify failed: {e!r}"))
                        return
                    for (_, _, _, fut), ok in zip(overflow, results):
                        if not fut.done():
                            fut.set_result(bool(ok))

                ex_fut.add_done_callback(deliver)
            else:
                results = batch_hook.host_batch_verify(pks, over_msgs, over_sigs)
                for (_, _, _, fut), ok in zip(overflow, results):
                    fut.set_result(bool(ok))
        return futs

    def _quiet_window(self) -> float:
        """How long the flusher waits for more arrivals before flushing:
        about four gaps while votes stream in, the floor when the next
        arrival is expected past the deadline anyway."""
        gap = self._ewma_gap
        if gap is None or 4 * gap >= self.flush_interval:
            return self.flush_min
        return max(4 * gap, self.flush_min)

    async def _wait_for_batch(self) -> None:
        """Adaptive coalescing: sleep until there is work, then extend in
        quiet windows while arrivals continue, capped at flush_interval."""
        loop = asyncio.get_running_loop()
        if not self._pending:
            await self._wake.wait()
            self._wake.clear()
        deadline = loop.time() + self.flush_interval
        while self._pending and len(self._pending) < self.max_batch:
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            before = self._enqueued
            try:
                await asyncio.wait_for(
                    self._wake.wait(), timeout=min(self._quiet_window(), remaining)
                )
            except asyncio.TimeoutError:
                if self._enqueued == before:
                    break  # a full quiet window with no arrivals: flush now
            self._wake.clear()

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if self.adaptive:
                await self._wait_for_batch()
            else:
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=self.flush_interval)
                except asyncio.TimeoutError:
                    pass
                self._wake.clear()
            if not self._pending:
                continue
            # cut at max_batch so one storm does not make an unbounded
            # batch; the rest flushes on the next iteration
            batch = self._pending[: self.max_batch]
            del self._pending[: self.max_batch]
            if len(self._pending) >= self.max_batch and self._wake:
                self._wake.set()
            now = loop.time()
            wait_s = max(0.0, now - batch[0][4])  # the oldest entry's queue wait
            quantum_s = self._quiet_window() if self.adaptive else self.flush_interval
            m = self.verifier.metrics
            m.queue_wait_seconds.observe(wait_s)
            m.flush_quantum_seconds.set(quantum_s)
            self.verifier.recorder.record(
                "verify.flush",
                batch=len(batch),
                wait_ms=round(wait_s * 1000, 3),
                quantum_ms=round(quantum_s * 1000, 3),
                shards=self.verifier.shards,
            )
            pubkeys = [b[0] for b in batch]
            msgs = [b[1] for b in batch]
            sigs = [b[2] for b in batch]
            try:
                results = await loop.run_in_executor(
                    self._executor, self.verifier.verify, pubkeys, msgs, sigs
                )
            except asyncio.CancelledError:
                for _, _, _, fut, _ in batch:
                    if not fut.done():
                        fut.cancel()
                raise
            except Exception as e:
                # a dead flusher would strand every pending and future
                # caller: fail this batch's futures and keep the loop alive
                err = batch_hook.EngineError if isinstance(e, batch_hook.EngineError) else RuntimeError
                for _, _, _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(err(f"batch verify failed: {e!r}"))
                continue
            for (_, _, _, fut, _), ok in zip(batch, results):
                if not fut.done():
                    fut.set_result(bool(ok))
