#!/usr/bin/env python3
"""Design trial of the BLS12-381 fold kernels on one CUDA card.

    python3 fold_trial.py [variant ...]      (default: every variant)
    python3 fold_trial.py --micro             (cycles of the pieces)

Each variant is the committed tendermint_tpu_torch/csrc/bls12_381_fold.cu
with a few lines replaced, and a number of points a block of the first tier
(ops/bls12_381_fold.py LEAVES), built from a copy of the package under
build/fold_trial/ (all builds at once).  Then, one variant after another in
the order given (a name may repeat, to interleave), each is held against the
plain version (tolerance 0; the run fails on any difference) at bucket 8 on
edge rows (a doubling, P + (-P), the identity on either side), at 256 rows
(every pair of level 0 a doubling) and at 10,000 rows, and timed at 10,000
rows (bucket 16,384): by CUDA events around the wrapper as chip_smoke.py's
phase 22 (a) times it, three means of 5 folds each after a warm-up, and by
the profiler's device time of the kernel, the mean of 5 (also at buckets
2, 8, 32, 128 and 1,024, whose slope is a level's cost).  The rows are
random canonical field elements, not curve points: the formulas never test
membership, so the kernels do the same work as on 10,000 distinct keys (no
pair shares an x).  Prints one line "TRIAL {json}" per run: each kernel's
ms, device ms, launches a fold, registers, stack and spill bytes, threads
and resident warps per SM at the first tier, and the card.

Variants:
  committed   G1 on eight lanes a pair in three multiply stages, points
              carrying Z^2 and Z^3; G2 on twelve lanes a pair (a slot of
              three lanes, one Karatsuba product each) in five stages; the
              stages a loop around one multiply, the CIOS in PTX carry
              chains with one accumulator; 128 points a block
  g1_quad     G1 on four lanes a pair in five stages over X, Y, Z, as G2
  g2_quad     G2 on four lanes a pair, each lane a whole Fp2 multiply
  mul_two_chains  the CIOS with two accumulators, so that a row runs two
              independent carry chains (the low halves' and the high
              halves')
  mul_twice   every field multiply done twice, the second waiting on the
              first: the multiplies' share of the time
  g1_maxnreg  the G1 kernel under __maxnreg__(255) in place of its launch
              bounds
  leaves_64, leaves_256   64 or 256 points a block of the first tier
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TRIAL_DIR = os.path.join(HERE, "build", "fold_trial")
SOURCE = os.path.join("tendermint_tpu_torch", "csrc", "bls12_381_fold.cu")

_G2_LANES = "using G2Lanes = KaratsubaFp2;"
_QUAD_FP2 = """// G2 on a quad: slot = lane & 3, each lane a whole Fp2 operation
struct QuadFp2 {
  using F = Fp2;
  static constexpr int kWidth = 4, kCoords = 3;
  int slot;
  __device__ explicit QuadFp2(int lane) : slot(lane & 3) {}
  __device__ bool writer() const { return slot < 3; }
  __device__ Fp2 from(const Fp2 &x, int s) const { return shfl(x, s, kWidth); }
  __device__ void mul(Fp2 &r, const Fp2 &a, const Fp2 &b) const {
    Fp sa, sb, t0, t1, t2;
    fp_mul(t0, a.c0, b.c0);
    fp_mul(t1, a.c1, b.c1);
    add(sa, a.c0, a.c1);
    add(sb, b.c0, b.c1);
    fp_mul(t2, sa, sb);
    sub(r.c0, t0, t1);
    sub(t2, t2, t0);
    sub(r.c1, t2, t1);
  }
  __device__ void sqr(Fp2 &r, const Fp2 &a) const {
    Fp s, d, t;
    add(s, a.c0, a.c1);
    sub(d, a.c0, a.c1);
    fp_mul(r.c0, s, d);
    fp_mul(t, a.c0, a.c1);
    add(r.c1, t, t);
  }
};

using G2Lanes = QuadFp2;"""

_G1_LANES = "using G1Lanes = OctFp;"
_QUAD_FP = """// G1 on a quad: slot = lane & 3, each lane a whole Fp operation
struct QuadFp {
  using F = Fp;
  static constexpr int kWidth = 4, kCoords = 3;
  int slot;
  __device__ explicit QuadFp(int lane) : slot(lane & 3) {}
  __device__ bool writer() const { return slot < 3; }
  __device__ Fp from(const Fp &x, int s) const { return shfl(x, s, kWidth); }
  __device__ void mul(Fp &r, const Fp &a, const Fp &b) const { fp_mul(r, a, b); }
  __device__ void sqr(Fp &r, const Fp &a) const { fp_mul(r, a, a); }
};

using G1Lanes = QuadFp;"""

_G1_BOUNDS = "__global__ void __launch_bounds__(kG1Threads)\n    fold_g1_kernel"

_MUL_DECL = "__device__ __forceinline__ void fp_mul(Fp &r, const Fp &a, const Fp &b) {"
_MUL_TWICE = """
// each multiply twice, the second waiting on the first (whose top bit is 0)
__device__ __forceinline__ void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  Fp t, c = b;
  fp_mul1(t, a, b);
  c.v[0] ^= t.v[kLimbs - 1] >> 31;
  fp_mul1(r, a, c);
}
"""

_MUL_START = "// r = a * b * R^-1 mod P, CIOS"
_MUL_END = "  fp_reduce(r, t);\n}\n"
_MUL_TWO_CHAINS = """// r = a * b * R^-1 mod P, CIOS with two accumulators, so that each row
// runs two independent carry chains: T takes the low halves of the
// products (a_j b_i at word j), U the high halves (at word j + 1), and the
// value is T + U + c.  For each word b_i of b: T += lo(a b_i) + c, U +=
// hi(a b_i); m = (T_0 + U_0) (-P^-1) mod 2^32; T += lo(m P), U += hi(m P);
// then T_0 + U_0 is 0 or 2^32, its carry c goes into the next row, and T
// and U shift down a word.  T keeps 13 words and U 14 (U_13 at most 3);
// the sum, the CIOS value, is below 2P.
__device__ __forceinline__ void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[kLimbs + 1], u[kLimbs + 2], c = 0, scratch;
#pragma unroll
  for (int j = 0; j <= kLimbs; ++j) t[j] = 0;
#pragma unroll
  for (int j = 0; j <= kLimbs + 1; ++j) u[j] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t bi = b.v[i];
    asm("add.cc.u32 %13, %27, 0xffffffff; madc.lo.cc.u32 %0, %14, %26, %0;\\n\\t"
        "madc.lo.cc.u32 %1, %15, %26, %1; madc.lo.cc.u32 %2, %16, %26, %2;\\n\\t"
        "madc.lo.cc.u32 %3, %17, %26, %3; madc.lo.cc.u32 %4, %18, %26, %4;\\n\\t"
        "madc.lo.cc.u32 %5, %19, %26, %5; madc.lo.cc.u32 %6, %20, %26, %6;\\n\\t"
        "madc.lo.cc.u32 %7, %21, %26, %7; madc.lo.cc.u32 %8, %22, %26, %8;\\n\\t"
        "madc.lo.cc.u32 %9, %23, %26, %9; madc.lo.cc.u32 %10, %24, %26, %10;\\n\\t"
        "madc.lo.cc.u32 %11, %25, %26, %11; addc.u32 %12, %12, 0;\\n\\t"
        : LIMBS12("+r", t), "+r"(t[kLimbs]), "=r"(scratch)
        : LIMBS12("r", a.v), "r"(bi), "r"(c));
    asm("mad.hi.cc.u32 %0, %13, %25, %0; madc.hi.cc.u32 %1, %14, %25, %1;\\n\\t"
        "madc.hi.cc.u32 %2, %15, %25, %2; madc.hi.cc.u32 %3, %16, %25, %3;\\n\\t"
        "madc.hi.cc.u32 %4, %17, %25, %4; madc.hi.cc.u32 %5, %18, %25, %5;\\n\\t"
        "madc.hi.cc.u32 %6, %19, %25, %6; madc.hi.cc.u32 %7, %20, %25, %7;\\n\\t"
        "madc.hi.cc.u32 %8, %21, %25, %8; madc.hi.cc.u32 %9, %22, %25, %9;\\n\\t"
        "madc.hi.cc.u32 %10, %23, %25, %10; madc.hi.cc.u32 %11, %24, %25, %11;\\n\\t"
        "addc.u32 %12, 0, 0;\\n\\t"
        : LIMBS12("+r", (u + 1)), "=r"(u[kLimbs + 1])
        : LIMBS12("r", a.v), "r"(bi));
    const uint32_t m = (t[0] + u[0]) * kN0;
    asm("mad.lo.cc.u32 %0, %13, 0xffffaaab, %0; madc.lo.cc.u32 %1, %13, 0xb9feffff, %1;\\n\\t"
        "madc.lo.cc.u32 %2, %13, 0xb153ffff, %2; madc.lo.cc.u32 %3, %13, 0x1eabfffe, %3;\\n\\t"
        "madc.lo.cc.u32 %4, %13, 0xf6b0f624, %4; madc.lo.cc.u32 %5, %13, 0x6730d2a0, %5;\\n\\t"
        "madc.lo.cc.u32 %6, %13, 0xf38512bf, %6; madc.lo.cc.u32 %7, %13, 0x64774b84, %7;\\n\\t"
        "madc.lo.cc.u32 %8, %13, 0x434bacd7, %8; madc.lo.cc.u32 %9, %13, 0x4b1ba7b6, %9;\\n\\t"
        "madc.lo.cc.u32 %10, %13, 0x397fe69a, %10; madc.lo.cc.u32 %11, %13, 0x1a0111ea, %11;\\n\\t"
        "addc.u32 %12, %12, 0;\\n\\t"
        : LIMBS12("+r", t), "+r"(t[kLimbs])
        : "r"(m));
    asm("mad.hi.cc.u32 %0, %13, 0xffffaaab, %0; madc.hi.cc.u32 %1, %13, 0xb9feffff, %1;\\n\\t"
        "madc.hi.cc.u32 %2, %13, 0xb153ffff, %2; madc.hi.cc.u32 %3, %13, 0x1eabfffe, %3;\\n\\t"
        "madc.hi.cc.u32 %4, %13, 0xf6b0f624, %4; madc.hi.cc.u32 %5, %13, 0x6730d2a0, %5;\\n\\t"
        "madc.hi.cc.u32 %6, %13, 0xf38512bf, %6; madc.hi.cc.u32 %7, %13, 0x64774b84, %7;\\n\\t"
        "madc.hi.cc.u32 %8, %13, 0x434bacd7, %8; madc.hi.cc.u32 %9, %13, 0x4b1ba7b6, %9;\\n\\t"
        "madc.hi.cc.u32 %10, %13, 0x397fe69a, %10; madc.hi.cc.u32 %11, %13, 0x1a0111ea, %11;\\n\\t"
        "addc.u32 %12, %12, 0;\\n\\t"
        : LIMBS12("+r", (u + 1)), "+r"(u[kLimbs + 1])
        : "r"(m));
    c = (t[0] | u[0]) != 0;  // t_0 + u_0 = 2^32 unless both are 0
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[j] = t[j + 1];
    t[kLimbs] = 0;
#pragma unroll
    for (int j = 0; j <= kLimbs; ++j) u[j] = u[j + 1];
    u[kLimbs + 1] = 0;
  }
  asm("add.cc.u32 %12, %25, 0xffffffff; addc.cc.u32 %0, %0, %13;\\n\\t"
      "addc.cc.u32 %1, %1, %14; addc.cc.u32 %2, %2, %15;\\n\\t"
      "addc.cc.u32 %3, %3, %16; addc.cc.u32 %4, %4, %17;\\n\\t"
      "addc.cc.u32 %5, %5, %18; addc.cc.u32 %6, %6, %19;\\n\\t"
      "addc.cc.u32 %7, %7, %20; addc.cc.u32 %8, %8, %21;\\n\\t"
      "addc.cc.u32 %9, %9, %22; addc.cc.u32 %10, %10, %23;\\n\\t"
      "addc.u32 %11, %11, %24;\\n\\t"
      : LIMBS12("+r", t), "=r"(scratch)
      : LIMBS12("r", u), "r"(c));
  fp_reduce(r, t);
}
"""

BUCKETS = (2, 8, 32, 128, 1024)

# name: (source edits, points a block); an edit ("mul", text) replaces the
# field multiply
VARIANTS = {
    "committed": ([], 128),
    "g2_quad": ([(_G2_LANES, _QUAD_FP2)], 128),
    "g1_quad": ([(_G1_LANES, _QUAD_FP)], 128),
    "mul_two_chains": ([("mul", _MUL_TWO_CHAINS)], 128),
    "mul_twice": ([(_MUL_DECL, _MUL_DECL.replace("fp_mul(", "fp_mul1(")),
                   (_MUL_END, _MUL_END + _MUL_TWICE)], 128),
    "g1_maxnreg": ([(_G1_BOUNDS, "__global__ void __maxnreg__(255)\n    fold_g1_kernel")], 128),
    "leaves_64": ([], 64),
    "leaves_256": ([], 256),
}


def make_variant(name: str) -> str:
    """A copy of the package whose fold source carries the variant's edits;
    returns the directory to put first on sys.path.  Variants with the
    committed source share one copy (one build)."""
    edits = VARIANTS[name][0]
    root = os.path.join(TRIAL_DIR, name if edits else "committed")
    if not edits and os.path.isdir(root):
        return root
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "tendermint_tpu_torch"),
                    os.path.join(root, "tendermint_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old == "mul":
            a, b = src.index(_MUL_START), src.index(_MUL_END) + len(_MUL_END)
            src = src[:a] + new + src[b:]
            continue
        if old not in src:
            raise KeyError(f"{name}: {old!r} not in {SOURCE}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def random_points(group: str, n: int, seed: int) -> list:
    """n tuples of random canonical coordinates (Fp2 ones as pairs)."""
    import numpy as np

    from tendermint_tpu_torch.crypto.bls.curve import P

    rng = np.random.default_rng(seed)

    def fe():
        return int.from_bytes(rng.bytes(48), "little") % P

    if group == "g1":
        return [(fe(), fe(), fe()) for _ in range(n)]
    return [tuple((fe(), fe()) for _ in range(3)) for _ in range(n)]


def edge_points(group: str, pts: list) -> list:
    """[a, a, b, -b, c, inf, inf, d]: a doubling, P + (-P) (the same x and
    Z, the other y) and the identity on either side at level 0."""
    from tendermint_tpu_torch.crypto.bls import curve

    a, b, c, d = pts[:4]
    if group == "g1":
        neg, inf = (b[0], -b[1] % curve.P, b[2]), curve.G1_INF
    else:
        neg, inf = (b[0], tuple(-v % curve.P for v in b[1]), b[2]), curve.G2_INF
    return [a, a, b, neg, c, inf, inf, d]


def run_variant(root: str, name: str) -> None:
    """In a child process whose sys.path starts at the variant's copy."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from tendermint_tpu_torch.crypto.bls import cuda_tier
    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import bls12_381_fold as bf

    bf.LEAVES = VARIANTS[name][1]
    lib = _build.lib()
    with open(_build.ptxas_log_path()) as f:
        log = f.read()
    dev = torch.device("cuda")
    out = {"variant": name, "leaves": bf.LEAVES}
    for group, gi in (("g1", 1), ("g2", 2)):
        rows_of = cuda_tier.g1_rows if group == "g1" else cuda_tier.g2_rows
        fold = bf.fold_g1 if group == "g1" else bf.fold_g2
        pts = random_points(group, 10_000, 2300 + gi)
        cases = {"edge 8": edge_points(group, pts), "256 doublings": [p for p in pts[:128]
                                                                      for _ in range(2)],
                 "10,000": pts}
        for case, case_pts in cases.items():
            rows = torch.as_tensor(rows_of(case_pts), device=dev)
            err = cs.max_abs_diff((fold(rows),), (bf.fold_plain(rows),))
            if err:
                raise AssertionError(f"{name}: {group} differs from its plain version on {case}")
        before = getattr(bf, f"{group.upper()}_LAUNCHES")
        fold(rows)
        launches = getattr(bf, f"{group.upper()}_LAUNCHES") - before
        leaves, blocks = bf.plan(rows.shape[0])[0]
        kernel = f"fold_{group}_kernel"
        ms = [cs.cuda_ms(lambda: fold(rows)) for _ in range(3)]
        device = cs.kernel_device_ms(lambda: [fold(rows) for _ in range(5)], [kernel])
        by_bucket = {}  # one block up to 128 points: the levels' cost
        for b in BUCKETS:
            r = torch.as_tensor(rows_of(pts[:b]), device=dev)
            d = cs.kernel_device_ms(lambda: [fold(r) for _ in range(5)], [kernel])
            by_bucket[b] = d[kernel] / 5 if kernel in d else None
        out[group] = {
            "ms": ms,
            "device_ms": device[kernel] / 5 if kernel in device else None,
            "device_ms_by_bucket": by_bucket,
            "launches_a_fold": launches,
            **_build.resources_of(f"fold_{group}_kernel", log),
            "threads": lib.bls12_381_fold_threads(gi, blocks),
            "resident_warps_per_sm": lib.bls12_381_fold_resident_warps(gi, leaves),
        }
    out["card"] = cs.card_line()
    print("TRIAL " + json.dumps(out), flush=True)


# --micro: cycles of the fold's pieces on one SM (clock64), from a small
# file that includes the committed source
_MICRO = """#include "%(source)s"

%(quad)s

namespace {

// one warp: `reps` of one operation in a chain
__global__ void micro_field(int op, const uint32_t *in, uint32_t *out, long long *cycles,
                            int reps) {
  Fp a, b;
  load(a, in + 12 * (threadIdx.x & 7));
  load(b, in + 96);
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
    if (op == 0) fp_mul(a, a, b);
    else if (op == 1) add(a, a, b);
    else if (op == 2) sub(a, a, b);
    else a = shfl(a, (threadIdx.x + 1) & 7, 8);
  }
  const long long t1 = clock64();
  store(out + 12 * threadIdx.x, a);
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// one warp: `reps` additions P = P + Q by the lane group L
template <class L>
__global__ void micro_pair(const uint32_t *in, long long *cycles, int reps) {
  constexpr int W = kPointWords<L>;
  uint32_t *pts = reinterpret_cast<uint32_t *>(fold_smem);
  for (int k = threadIdx.x; k < 2 * W; k += blockDim.x) pts[k] = in[k];
  __syncthreads();
  const L l(threadIdx.x & 31);
  const long long t0 = clock64();
  for (int i = 0; i < reps; ++i) {
    const auto o = pair_add(l, pts, pts + W, true);
    __syncwarp();
    if ((int)threadIdx.x < L::kWidth && l.writer()) store(pts + l.slot * kWords<typename L::F>, o);
    __syncwarp();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// one block of 256 threads: the levels of 128 points in shared memory
template <class L>
__global__ void micro_levels(const uint32_t *in, long long *cycles) {
  constexpr int W = kPointWords<L>;
  uint32_t *pts = reinterpret_cast<uint32_t *>(fold_smem);
  for (int k = threadIdx.x; k < 128 * W; k += blockDim.x) pts[k] = in[k];
  __syncthreads();
  const long long t0 = clock64();
  fold_levels<L>(pts, 128);
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

}  // namespace

// cycles of one piece: which 0-3 a field multiply, add, subtraction,
// shuffle; 4-6 a pair addition on OctFp, QuadFp, KaratsubaFp2; 7-9 a level
// of 128 points (all seven levels / 7) on the same
extern "C" double micro_run(int which, int reps) {
  static uint32_t host[128 * 72];
  uint32_t x = 12345;
  for (int k = 0; k < 128 * 72; ++k) {
    x = x * 1664525u + 1013904223u;
    host[k] = (k %% 12 == 11) ? (x & 0x0fffffffu) : x;  // below P
  }
  uint32_t *in, *out;
  long long *cyc, c = 0;
  cudaMalloc(&in, sizeof(host));
  cudaMalloc(&out, sizeof(host));
  cudaMalloc(&cyc, sizeof(long long));
  cudaMemcpy(in, host, sizeof(host), cudaMemcpyHostToDevice);
  const size_t smem = 128 * 72 * 4;
  if (which < 4) micro_field<<<1, 32>>>(which, in, out, cyc, reps);
  else if (which == 4) micro_pair<OctFp><<<1, 32, smem>>>(in, cyc, reps);
  else if (which == 5) micro_pair<QuadFp><<<1, 32, smem>>>(in, cyc, reps);
  else if (which == 6) micro_pair<KaratsubaFp2><<<1, 32, smem>>>(in, cyc, reps);
  else {
    cudaFuncSetAttribute(micro_levels<KaratsubaFp2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (which == 7) micro_levels<OctFp><<<1, 256, smem>>>(in, cyc);
    else if (which == 8) micro_levels<QuadFp><<<1, 256, smem>>>(in, cyc);
    else micro_levels<KaratsubaFp2><<<1, 256, smem>>>(in, cyc);
    reps = 7;
  }
  const cudaError_t rc = cudaDeviceSynchronize();
  cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
  cudaFree(in);
  cudaFree(out);
  cudaFree(cyc);
  return rc == cudaSuccess ? (double)c / reps : -1.0;
}
"""

MICRO = ("mul", "add", "sub", "shfl", "pair g1 oct", "pair g1 quad", "pair g2 karatsuba",
         "level g1 oct", "level g1 quad", "level g2 karatsuba")


def micro() -> None:
    """Builds the micro-benchmark beside the committed source and prints
    one line "MICRO {json}": cycles of each piece (clock64, one SM)."""
    import ctypes

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from tendermint_tpu_torch.ops import _build

    root = os.path.join(TRIAL_DIR, "micro")
    os.makedirs(root, exist_ok=True)
    cu, so = os.path.join(root, "micro.cu"), os.path.join(root, "micro.so")
    quad = _QUAD_FP.rsplit("\\n\\nusing", 1)[0]
    with open(cu, "w") as f:
        f.write(_MICRO % {"source": os.path.join(HERE, SOURCE), "quad": quad})
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(so)
    lib.micro_run.restype = ctypes.c_double
    lib.micro_run.argtypes = [ctypes.c_int, ctypes.c_int]
    res = {name: lib.micro_run(k, 64 if k < 7 else 1) for k, name in enumerate(MICRO)}
    res["card"] = cs.card_line()
    print("MICRO " + json.dumps(res), flush=True)


def main() -> int:
    if sys.argv[1:] == ["--micro"]:
        micro()
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run_variant(sys.argv[2], sys.argv[3])
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    roots = {n: make_variant(n) for n in dict.fromkeys(names)}
    build = "from tendermint_tpu_torch.ops import _build; _build.lib()"
    procs = {r: subprocess.Popen([sys.executable, "-c", build], cwd=r)
             for r in dict.fromkeys(roots.values())}
    for r, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"{r} did not build")
    failed = [n for n in names if subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--run", roots[n], n]).returncode != 0]
    if failed:
        print(f"failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
