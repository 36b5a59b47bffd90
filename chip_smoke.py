#!/usr/bin/env python3
"""Smoke run of tendermint_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Setup: prints the card (nvidia-smi name and power limit), builds the
   CUDA kernels from the checkout's sources and the host-prep C library.
2. Each kernel against its plain torch version on the card, on the same
   inputs, tolerance 0 (integer math): kernel 1 (ladder) and kernel 3
   (tabulated verify) at B = 1024 on a mix of valid signatures and every
   corruption class, comparing verdicts and the R' encodings; kernel 2
   (window tables) for 64 validators, bit for bit.  Verdicts of real
   signatures are also held against the pure-Python ed25519 oracle.
3. The main path at full size: a 10,000-validator set signs a full commit;
   ValidatorSet.verify_commit runs through the crypto.batch hooks on the
   ladder, on the tabulated path and under the auto profile, then the
   failure cases and a flat 512-vote batch.  Launch counters are zeroed
   just before this phase and read just after it.
4. Each kernel at the main path's shapes (B = V = 10,000): its output held
   against its plain version's on the same inputs, tolerance 0 (verdicts
   and R' encodings of the commit, window tables bit for bit), its time
   (CUDA events) beside the plain version's, and its bound from the shapes.

Prints, before the last line, a JSON object {"kernels": [...]} and the card
line; the last line is {"ok": true, "device": {...}}.  Exits non-zero,
printing no result, without a card, outside a checkout, or when any phase
fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_VALIDATORS = 10_000
KERNEL_BATCH = 1024
TABLE_VALIDATORS = 64
FLAT_BATCH = 512
CHAIN_ID = "chip-smoke"

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s
# float32 outside the tensor cores.  The integer multiply rate is not in the
# data sheet; the bound assumes one 32x32->64 partial product (one
# IMAD.WIDE.U32) per lane per clock on 64 of the 128 lanes of an SM, half
# the float32 FMA rate: 67e12 / 2 / 2 per second.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
# A 64x64->128 product is 4 such partial products.  In 64x64->128 products
# (csrc/fe51.cuh): a field multiply 25, a squaring 15; a point doubling
# 4 squarings + 4 multiplies, a complete add 9 multiplies, a mixed add 7;
# the finish an inversion (254 squarings + 11 multiplies) and 2 multiplies.
IMAD_PER_PRODUCT = 4
MUL, SQ = 25, 15
DOUBLE, ADD, MADD = 4 * SQ + 4 * MUL, 9 * MUL, 7 * MUL
FINISH = 254 * SQ + 11 * MUL + 2 * MUL


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def sass_counts(so: str):
    """(function, IMAD instructions, of them IMAD.WIDE, all instructions)
    for each device function in the built library's SASS, from cuobjdump;
    the field helpers are __noinline__ and so show as functions of their
    own.  Empty when cuobjdump is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=120)
    counts, name = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts.setdefault(name, [0, 0, 0])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            c = counts[name]
            c[2] += 1
            if op.startswith("IMAD"):
                c[0] += 1
                c[1] += op.startswith("IMAD.WIDE")
    return [(k, *v) for k, v in counts.items()]


def bound(products: float, nbytes: float):
    ops_ms = products * IMAD_PER_PRODUCT / IMAD_PER_S * 1000
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1000
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000


def make_keys(n, prefix="val"):
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey

    return [Ed25519PrivKey.from_secret(f"{prefix}-{i}".encode()) for i in range(n)]


def kernel_mix(rng, keys):
    """KERNEL_BATCH rows cycling through every input class the kernels see.
    Returns the pubkey rows and the per-signature kernel inputs (idx, h_le,
    s_le, r_y, r_sign), the host-prep `valid` mask, the pure-Python oracle's
    verdicts, and `real`: the rows whose inputs are a real signature's."""
    import numpy as np

    from tendermint_tpu_torch.crypto import ed25519_math as em
    from tendermint_tpu_torch.crypto import batch_verifier as bvm

    ident_pk = (1).to_bytes(32, "little")  # the identity point (small order)
    bad_pk = b"\xff" * 32  # y >= p: fails decompression
    pubkeys = [k.pub_key().bytes() for k in keys] + [ident_pk, bad_pk]
    n_keys = len(keys)
    triples, idx, kinds = [], [], []
    p_plus_1 = (em.P + 1).to_bytes(32, "little")  # non-canonical encoding of y = 1
    for i in range(KERNEL_BATCH):
        kind = i % 10
        k = i % n_keys
        msg = f"vote-{i}".encode()
        sig = keys[k].sign(msg)
        pk_idx = k
        if kind == 1:  # wrong message
            msg = msg + b"!"
        elif kind == 2:  # wrong key
            pk_idx = (k + 1) % n_keys
        elif kind == 3:  # flipped R bit
            b = bytearray(sig)
            b[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        elif kind == 4:  # flipped s bit
            b = bytearray(sig)
            b[32 + int(rng.integers(0, 31))] ^= 1 << int(rng.integers(0, 8))
            sig = bytes(b)
        elif kind == 5:  # identity key, R = identity, s = 0: cofactorless accept
            pk_idx, sig = n_keys, ident_pk + bytes(32)
        elif kind == 6:  # same, but R encoded non-canonically (y = p + 1)
            pk_idx, sig = n_keys, p_plus_1 + bytes(32)
        elif kind == 7:  # invalid pubkey row
            pk_idx = n_keys + 1
        triples.append((pubkeys[pk_idx], msg, sig))
        idx.append(pk_idx)
        kinds.append(kind)
    neg_a, h_dig, s_dig, r_y, r_sign, valid = bvm.prepare_batch(*zip(*triples))
    h_le, s_le = bvm._pack_digits(h_dig), bvm._pack_digits(s_dig)
    rows = np.stack(
        [bvm._neg_a_limbs(pk) if bvm._neg_a_limbs(pk) is not None else bvm.IDENTITY_ROW
         for pk in pubkeys]
    )
    oracle = np.array([em.verify(*t) for t in triples])
    for i, kind in enumerate(kinds):
        if kind == 8:  # real point, random scalars: compares R' off the signature path
            h_le[i] = rng.integers(0, 256, 32, dtype=np.uint8)
            s_le[i] = rng.integers(0, 256, 32, dtype=np.uint8)
        elif kind == 9:  # padding row
            idx[i] = 0
            h_le[i] = 0
            s_le[i] = 0
            r_y[i] = 0
            r_sign[i] = 0
    real = np.array([kind not in (8, 9) for kind in kinds])
    return rows, np.array(idx, dtype=np.int32), h_le, s_le, r_y, r_sign, valid, oracle, real


def phase_kernels(rng, keys, report, dev):
    """Every kernel against its plain version on the card, tolerance 0."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import ed25519, ed25519_cuda, ed25519_table

    rows, idx, h_le, s_le, r_y, r_sign, valid, oracle, real = kernel_mix(rng, keys)
    t = dict(
        rows=torch.as_tensor(rows, device=dev), idx=torch.as_tensor(idx, device=dev),
        h=torch.as_tensor(h_le, device=dev), s=torch.as_tensor(s_le, device=dev),
        ry=torch.as_tensor(r_y, device=dev), rs=torch.as_tensor(r_sign, device=dev),
    )

    def compare(name, got, want):
        (ok_k, r_k), (ok_p, r_p) = got, want
        mismatched = int((ok_k != ok_p).sum())
        err = int((r_k.int() - r_p.int()).abs().max())
        verdicts = np.logical_and(ok_k.cpu().numpy(), valid)
        oracle_bad = int((verdicts[real] != oracle[real]).sum())
        log(f"  {name}: B={len(idx)} accepted={int(verdicts.sum())} verdict mismatches={mismatched} "
            f"R' max|diff|={err} oracle mismatches={oracle_bad}")
        if mismatched or err or oracle_bad:
            raise AssertionError(f"{name} disagrees with its plain version or the oracle")
        report[name]["max_abs_err"] = float(max(err, mismatched))

    got = ed25519_cuda.verify_indexed(t["rows"], t["idx"], t["h"], t["s"], t["ry"], t["rs"], want_r=True)
    want = ed25519.verify_prepared_packed(
        t["rows"][t["idx"].long()], t["h"], t["s"], t["ry"], t["rs"], want_r=True)
    compare("ed25519_ladder", got, want)

    tab_rows = t["rows"][:TABLE_VALIDATORS].contiguous()
    tables_k = ed25519_table.build_window_tables(tab_rows)
    tables_p = ed25519_table.build_window_tables_plain(tab_rows)
    diff = int((tables_k.int() - tables_p.int()).abs().max())
    log(f"  ed25519_window_tables: V={TABLE_VALIDATORS} entries={tables_k.shape[0]} max|diff|={diff}")
    if diff:
        raise AssertionError("window tables differ from the plain build")
    report["ed25519_window_tables"]["max_abs_err"] = float(diff)

    # the tabulated kernel needs every row tabulated: table the full row set
    tables_all = ed25519_table.build_window_tables(t["rows"])
    got = ed25519_table.verify_tabulated(tables_all, t["idx"], t["h"], t["s"], t["ry"], t["rs"], want_r=True)
    want = ed25519_table.verify_tabulated_plain(
        tables_all, t["idx"], ed25519.expand_digits(t["h"]), ed25519.expand_digits(t["s"]),
        t["ry"], t["rs"], want_r=True)
    compare("ed25519_tabulated", got, want)


def build_commit(keys):
    from tendermint_tpu_torch.types.block import BlockID, Commit, PartSetHeader
    from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
    from tendermint_tpu_torch.types.vote import Vote

    vset = ValidatorSet([Validator.new(k.pub_key(), 10) for k in keys])
    by_addr = {k.pub_key().address(): k for k in keys}
    bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
    sigs, msgs = [], []
    for i, v in enumerate(vset.validators):
        vote = Vote(PRECOMMIT_TYPE, 7, 0, bid, 1_700_000_000_000_000_000 + i, v.address, i)
        msg = vote.sign_bytes(CHAIN_ID)
        vote.signature = by_addr[v.address].sign(msg)
        sigs.append(vote.commit_sig())
        msgs.append(msg)
    return vset, bid, Commit(7, 0, bid, sigs), msgs


def phase_main(keys, card, dev):
    """The main path at full width; returns what the timing phase reuses."""
    import dataclasses

    from tendermint_tpu_torch.crypto import batch as batch_hook
    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.types.block import CommitSig, Commit
    from tendermint_tpu_torch.types.validator import NotEnoughVotingPowerError

    t0 = time.perf_counter()
    vset, bid, commit, msgs = build_commit(keys)
    log(f"  built and signed a {vset.size()}-validator commit in {(time.perf_counter() - t0):.3f} s")
    bv = bvm.BatchVerifier(device=dev).install()

    def run(label, cache):
        cache.install()
        ms = wall_ms(lambda: vset.verify_commit(CHAIN_ID, bid, 7, commit))
        d = bv.last_dispatch
        log(f"  verify_commit [{label}] path={d['path']} n={d['n']} total_ms={ms:.3f} "
            f"host_prep_ms={d['host_prep_ms']:.3f} device_ms={d['device_ms']:.3f} ({card})")

    ladder = bvm.TableCache(bv, tabulated=False)
    run("ladder, cold table", ladder)
    run("ladder, warm table", ladder)
    tab = bvm.TableCache(bv, tabulated=True)
    run("tabulated, cold tables", tab)
    run("tabulated, warm tables", tab)
    auto = bvm.TableCache(bv, tabulated=None)
    run("auto, cold", auto)
    run("auto, warm", auto)
    prof = next(iter(bvm.tabulated_profiles.values()))
    log(f"  auto profile: tabulated={'engaged' if prof['tab_ms'] < prof['ladder_ms'] else 'off'} "
        f"tab_ms={prof['tab_ms']:.3f} ladder_ms={prof['ladder_ms']:.3f} "
        f"table_build_ms={prof['table_build_ms']:.3f} at B={int(prof['batch'])} ({card})")
    # the host work of verify_commit outside host prep and the dispatch
    t0 = time.perf_counter()
    commit.validate_basic()
    for i in range(commit.size()):
        commit.vote_sign_bytes(CHAIN_ID, i)
    log(f"  verify_commit host side: validate_basic + {commit.size()} sign-bytes "
        f"{(time.perf_counter() - t0) * 1000:.3f} ms ({card})")

    bad_i = min(1234, vset.size() - 1)
    sigs = list(commit.signatures)
    s = bytearray(sigs[bad_i].signature)
    s[0] ^= 1
    sigs[bad_i] = dataclasses.replace(sigs[bad_i], signature=bytes(s))
    try:
        vset.verify_commit(CHAIN_ID, bid, 7, Commit(7, 0, bid, sigs))
        raise AssertionError("tampered commit verified")
    except ValueError as e:
        if not str(e).startswith(f"wrong signature (#{bad_i})"):
            raise
        log(f"  tampered commit: raised '{str(e)[:40]}...'")

    absent = vset.size() // 3 + 1
    thin = Commit(7, 0, bid, [CommitSig.absent()] * absent + list(commit.signatures[absent:]))
    try:
        vset.verify_commit(CHAIN_ID, bid, 7, thin)
        raise AssertionError("commit with >= 1/3 absent verified")
    except NotEnoughVotingPowerError as e:
        log(f"  {absent} absent: raised NotEnoughVotingPowerError (got {e.got}, needed > {e.needed})")
    vset.verify_commit_trusting(CHAIN_ID, bid, 7, thin)
    log(f"  verify_commit_trusting at 1/3 with {absent} absent: passed")

    pks = [v.pub_key.bytes() for v in vset.validators[:FLAT_BATCH]]
    flat_sigs = [cs.signature for cs in commit.signatures[:FLAT_BATCH]]
    ok = bv.verify(pks, msgs[:FLAT_BATCH], flat_sigs)
    if ok != [True] * FLAT_BATCH:
        raise AssertionError("flat batch rejected valid votes")
    d = bv.last_dispatch
    log(f"  flat BatchVerifier.verify n={d['n']} host_prep_ms={d['host_prep_ms']:.3f} "
        f"device_ms={d['device_ms']:.3f} ({card})")
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)
    return vset, commit, msgs, tab


def max_abs_diff(got, want) -> int:
    """Largest |kernel - plain| over paired tensors; 0 when they are equal."""
    import torch

    return max(0 if torch.equal(a, b) else int((a.int() - b.int()).abs().max())
               for a, b in zip(got, want))


def hold(name, report, got, want, what):
    """Kernel output against its plain version's at tolerance 0; the
    report's max_abs_err is the largest difference of any comparison."""
    err = max_abs_diff(got, want)
    log(f"  {name}: {what} max|kernel - plain|={err}")
    if err:
        raise AssertionError(f"{name} disagrees with its plain version at the main path's shapes")
    report[name]["max_abs_err"] = float(max(report[name].get("max_abs_err", 0.0), err))


def phase_timing(vset, commit, msgs, tab_cache, report):
    """Kernel against plain, kernel and plain times, and bounds, at the main
    path's shapes (the 10k commit, its 10k pubkey rows and window tables)."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import batch_verifier as bvm
    from tendermint_tpu_torch.ops import ed25519, ed25519_cuda, ed25519_table

    table = tab_cache.table_for(vset.pubkeys_digest(), None)
    n = vset.size()
    items = [(v.pub_key.bytes(), m, cs.signature)
             for v, m, cs in zip(vset.validators, msgs, commit.signatures)]
    idx, h, s, ry, rs = bvm._device_rows(table.device, np.arange(n), *bvm._scalar_rows(items)[:4])
    rows, tables = table.neg_a_rows, table.build_tables()
    plain = []

    def keep(fn):
        return lambda: plain.append(fn())

    # ladder: the commit's verdicts (all valid) and R' encodings
    k_ms = cuda_ms(lambda: ed25519_cuda.verify_indexed(rows, idx, h, s, ry, rs))
    got = ed25519_cuda.verify_indexed(rows, idx, h, s, ry, rs, want_r=True)
    p_ms = wall_ms(keep(lambda: ed25519.verify_prepared_packed(
        rows[idx.long()], h, s, ry, rs, want_r=True)))
    if not bool(got[0].all()):
        raise AssertionError("ed25519_ladder rejected a valid commit signature")
    hold("ed25519_ladder", report, got, plain.pop(), f"B={n} verdicts and R' bytes")
    products = n * (7 * DOUBLE + 7 * ADD + 64 * (4 * DOUBLE + ADD + MADD) + FINISH)
    b_ms, b_by = bound(products, nbytes(rows, idx, h, s, ry, rs) + 2 * n)
    report["ed25519_ladder"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)

    # window tables: the kernel's build against the plain build, bit for bit
    k_ms = cuda_ms(lambda: ed25519_table.build_window_tables(rows), reps=2)
    p_ms = wall_ms(keep(lambda: ed25519_table.build_window_tables_plain(rows)))
    hold("ed25519_window_tables", report, (ed25519_table.build_window_tables(rows),),
         (plain.pop(),), f"V={rows.shape[0]} tables")
    products = rows.shape[0] * 64 * (14 * ADD + 4 * DOUBLE)
    b_ms, b_by = bound(products, nbytes(rows, tables))
    report["ed25519_window_tables"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)

    # tabulated verify: table bytes counted for the rows this commit reads
    k_ms = cuda_ms(lambda: ed25519_table.verify_tabulated(tables, idx, h, s, ry, rs))
    got = ed25519_table.verify_tabulated(tables, idx, h, s, ry, rs, want_r=True)
    hd, sd = ed25519.expand_digits(h), ed25519.expand_digits(s)
    p_ms = wall_ms(keep(lambda: ed25519_table.verify_tabulated_plain(
        tables, idx, hd, sd, ry, rs, want_r=True)))
    if not bool(got[0].all()):
        raise AssertionError("ed25519_tabulated rejected a valid commit signature")
    hold("ed25519_tabulated", report, got, plain.pop(), f"B={n} verdicts and R' bytes")
    w = torch.arange(64, device=idx.device)
    rows_read = torch.unique((idx.long()[:, None] * 64 + w) * 16 + hd.long().flip(1)).numel()
    row_bytes = 4 * 20 * tables.element_size()
    base_bytes = 64 * 16 * 4 * 20 * 4
    products = n * (128 * ADD + FINISH)
    b_ms, b_by = bound(products, rows_read * row_bytes + base_bytes + nbytes(idx, h, s, ry, rs) + 2 * n)
    report["ed25519_tabulated"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tendermint_tpu_torch")):
        print("chip_smoke: run from a checkout (tendermint_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import numpy as np

    from tendermint_tpu_torch.crypto import hostprep
    from tendermint_tpu_torch.ops import _build, ed25519_cuda, ed25519_table

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    log("[1] setup")
    t0 = time.perf_counter()
    _build.lib()
    log(f"  CUDA kernels built in {time.perf_counter() - t0:.3f} s ({_build.library_path()})")
    with open(_build.ptxas_log_path()) as f:
        for line in f:
            if "Used" in line or "spill" in line or line.startswith("=="):
                log("  ptxas: " + line.strip())
    for fn, imad, wide, total in sass_counts(_build.library_path()):
        log(f"  sass: {fn} IMAD={imad} (IMAD.WIDE={wide}) instructions={total}")
    if not hostprep.have_fast_prep():
        raise AssertionError("host-prep C library did not build")
    t0 = time.perf_counter()
    keys = make_keys(N_VALIDATORS)
    log(f"  {N_VALIDATORS} keys in {time.perf_counter() - t0:.3f} s")

    report = {
        name: {"name": name, "route": "cuda", "source": src, "replaces": rep, "library_ms": None}
        for name, src, rep in (
            ("ed25519_ladder", "tendermint_tpu_torch/csrc/ed25519_ladder.cu",
             "tendermint_tpu/ops/ed25519_pallas.py:161"),
            ("ed25519_tabulated", "tendermint_tpu_torch/csrc/ed25519_table.cu",
             "tendermint_tpu/ops/ed25519_table.py:176"),
            ("ed25519_window_tables", "tendermint_tpu_torch/csrc/ed25519_table.cu",
             "tendermint_tpu/ops/ed25519_table.py:65"),
        )
    }

    log("[2] kernels vs plain versions (tolerance 0)")
    dev = torch.device("cuda")
    phase_kernels(np.random.default_rng(2024), keys[:TABLE_VALIDATORS], report, dev)

    log("[3] main path: 10k-validator commit through the hooks")
    ed25519_cuda.LAUNCHES = 0
    ed25519_table.BUILD_LAUNCHES = 0
    ed25519_table.SUM_LAUNCHES = 0
    vset, commit, msgs, tab_cache = phase_main(keys, card, dev)
    counts = {
        "ed25519_ladder": ed25519_cuda.LAUNCHES,
        "ed25519_window_tables": ed25519_table.BUILD_LAUNCHES,
        "ed25519_tabulated": ed25519_table.SUM_LAUNCHES,
    }
    log(f"  launches on the main path: {counts}")
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        report[name]["launches"] = c

    log("[4] kernels vs plain versions and timing at the main path's shapes")
    phase_timing(vset, commit, msgs, tab_cache, report)
    for r in report.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.1f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}) ({card})")

    keys_order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys_order} for r in report.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
