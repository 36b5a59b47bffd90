// Kernels 2 and 3: per-validator window tables and the zero-doubling
// tabulated verify.
//
//   table[v, w, d] = d * 16^w * (-A_v)      (w = 0..63, d = 0..15)
//   R' = sum_w table[idx, w, h_w] + sum_w base[w, s_w]     (128 point adds)
//
// Kernel 2 (window-table build) replaces the XLA lax.scan
// tendermint_tpu/ops/ed25519_table.py _build_tables_jit; plain version
// ops/ed25519_table.py build_window_tables_plain.  Bound on the H100:
// integer multiply throughput (per validator 64 x (14 adds from a cached
// P_w + its conversion) and 252 doublings, 221k 64x64->128 products, plus
// 4096 canonicalizations), with the 1.6 GB of output at 10k validators
// close behind (0.49 ms of bytes against 0.53 ms of products).  The windows
// depend on each other only through the doubling chain P_{w+1} = 16 * P_w
// (18 % of the products); the 14 adds of window w need only P_w.  So a
// build is two launches on the caller's stream:
//   pass A (chain_kernel): one quad per validator (ge_quad.cuh) runs the
//     252 doublings and writes entries 0 (identity) and 1 (canonical P_w)
//     of every window, staged per quad in shared memory and stored as
//     16-byte vectors;
//   pass B (windows_kernel): one thread per (validator, window), 640,000 at
//     10k, reads P_w back from entry 1, converts it once to the cached form
//     (Y-X, Y+X, 2d*T, Z) and runs the 14 adds m = m + P_w of
//     _build_tables_jit, writing entries 2..15 as 16-byte vector stores
//     (80 int16 limbs packed into 10 uint4).
// Starting pass B from the canonical P_w instead of the running
// representative, and adding it in the cached form, changes no entry: the
// formulas are polynomials over F_p, so equal field elements in give equal
// field elements out, and entries are stored canonical
// (tests/test_torch_ed25519.py pins the split on the CPU).
// Every entry is canonical int16 13-bit limbs in the JAX layout
// [V*64*16, 4, 20], bit-identical to the JAX build, so tables carry across
// between the two packages.
//
// Kernel 3 (tabulated_kernel) replaces the Pallas TPU kernel
// tendermint_tpu/ops/ed25519_table.py _sum_verify -> _sum_kernel and the
// [128, 4, 20, B] XLA gather in front of it (verify_tabulated); plain
// version ops/ed25519_table.py verify_tabulated_plain.  Bound on the H100:
// integer multiply throughput.  Per signature 64 table rows, each converted
// to the cached form (1 multiply) and added (8), 64 base windows by mixed
// add (7), one add that joins the two quads' sums and the finish: 29,960
// 64x64->128 products, 0.072 ms at 10k signatures, against ~0.03 ms of
// bytes (64 random 160-byte int16 rows per signature from the validator
// tables, about 100 MB for a 10k commit; the 240 KB base table stays in
// L2).  What holds it on the card is instruction slots more than latency: the
// design variants tried (tabulated_trial.py) ranked by their total warp
// instructions, not by the length of a lane's chain (PERF.md).
//
// Design: eight lanes per signature, two quads (ge_quad.cuh), 16 signatures
// per 128-thread block.  Quad q sums windows 32q ... 32q + 31 of both
// halves: the validator-table rows h_w (lane j reads coordinate j of the
// row as five 8-byte loads, straight from global memory by index, one
// window ahead; converted to the cached form, then the quad add) and the
// base windows s_w in madd form (y-x, y+x, 2d*x*y; base_windows_madd, 13-bit
// int32 limbs, converted on load; lane 3 passes any of the three, as in
// kernel 1).  The two chains are independent and equally long: each lane
// runs 32 x 3 + 32 x 2 multiply steps, and a 10k commit launches 80,000
// threads.  Each quad then takes the other's sum by one cross-quad shuffle
// and adds it (3 steps).  Lanes past `batch` clamp to the last signature
// and store nothing, so every shuffle has its full warp.
// The finish (inversion, x, y, compare: about half of a lane's chain) runs
// once per signature on one thread: quad 0 leaves X, Y, Z in shared memory
// and the block's first 16 threads finish a signature each.  Run on every
// lane of both quads (quad_finish, as the ladder does), it took the warps
// twice the instruction slots per signature that one quad would, and the
// kernel was slower than one quad per signature (PERF.md).  128-thread
// blocks hold the finish to half of one warp of four; 64 or 256 were
// slower, as were caps on registers (spills) and an L1-heavy carveout (it
// leaves too little shared memory for three blocks).
// The sum order differs from the plain version's (one chain of 128
// complete adds), so projective limbs differ; verdicts and canonical R' do
// not.  The TPU kernel carried its accumulator across a sequential grid
// axis in VMEM; here the sum is a loop in the quad.
#include <cuda_runtime.h>

#include "ge_quad.cuh"

namespace {

constexpr int kThreads = 128;      // pass B
constexpr int kChainQuads = 16;    // pass A: validators per block of 64
constexpr int kChainThreads = 4 * kChainQuads;
constexpr int kSumQuads = 2;       // kernel 3: quads per signature
constexpr int kSumLanes = 4 * kSumQuads;
constexpr int kSumWindows = 64 / kSumQuads;
constexpr int kSumThreads = 128;   // kernel 3
constexpr int kSumSigs = kSumThreads / kSumLanes;  // signatures per block
static_assert((kSumQuads & (kSumQuads - 1)) == 0 && kSumLanes <= 32 &&
                  kSumThreads % kSumLanes == 0,
              "a power-of-two number of quads per signature, in one warp");

// the 80 int16 limbs of an entry as 40 little-endian 32-bit words
struct PackedLimbs {
  const uint32_t *w;
  __device__ __forceinline__ uint32_t operator[](int n) const {
    return (w[n >> 1] >> (16 * (n & 1))) & 0xffff;
  }
};

// canonical (X, Y, Z, T) -> one [4, 20] int16 entry as 10 16-byte stores
__device__ __forceinline__ void entry_store(int16_t *out, const ge &p) {
  fe c[4] = {p.X, p.Y, p.Z, p.T};
#pragma unroll
  for (int k = 0; k < 4; k++) fe_canon(c[k]);
  uint4 *o = reinterpret_cast<uint4 *>(out);
#pragma unroll
  for (int k = 0; k < 10; k++) {
    uint32_t w[4];
#pragma unroll
    for (int m = 0; m < 4; m++) {
      const int n = 8 * k + 2 * m;  // limbs n and n + 1 (same coordinate)
      w[m] = (uint32_t)fe_limb13(c[n / 20], n % 20) |
             ((uint32_t)fe_limb13(c[n / 20], n % 20 + 1) << 16);
    }
    o[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// one [4, 20] int16 entry, read as 10 16-byte loads
__device__ __forceinline__ void entry_load(ge &p, const int16_t *in) {
  const uint4 *src = reinterpret_cast<const uint4 *>(in);
  uint32_t w[40];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    const uint4 u = src[k];
    w[4 * k] = u.x;
    w[4 * k + 1] = u.y;
    w[4 * k + 2] = u.z;
    w[4 * k + 3] = u.w;
  }
  fe_from13(p.X, PackedLimbs{w});
  fe_from13(p.Y, PackedLimbs{w + 10});
  fe_from13(p.Z, PackedLimbs{w + 20});
  fe_from13(p.T, PackedLimbs{w + 30});
}

// Pass A: quad q of the block carries validator v; lane j owns coordinate j.
__global__ void __launch_bounds__(kChainThreads)
    chain_kernel(const int16_t *__restrict__ rows,  // [V, 4, 20] -A
                 int16_t *__restrict__ out,         // [V*64*16, 4, 20]
                 int n_rows) {
  // entries 0 and 1 of the current window, per quad: 20 16-byte vectors
  __shared__ __align__(16) int16_t stage[kChainQuads][160];
  const int j = threadIdx.x & 3;
  const int q = threadIdx.x >> 2;
  const int v = blockIdx.x * kChainQuads + q;
  const bool live = v < n_rows;
  const int vc = live ? v : n_rows - 1;  // the quad runs, stores nothing
  int16_t *st = stage[q];
  for (int k = j; k < 80; k += 4) st[k] = (k == 20 || k == 40) ? 1 : 0;  // identity
  fe p;
  fe_from13(p, rows + 80 * (size_t)vc + 20 * j);
  for (int w = 0; w < 64; w++) {
    fe c = p;
    fe_canon(c);
#pragma unroll
    for (int l = 0; l < 20; l++) st[80 + 20 * j + l] = (int16_t)fe_limb13(c, l);
    __syncwarp();
    if (live) {
      uint4 *dst = reinterpret_cast<uint4 *>(out + (size_t)80 * 16 * (64 * (size_t)v + w));
      const uint4 *src = reinterpret_cast<const uint4 *>(st);
      for (int k = j; k < 20; k += 4) dst[k] = src[k];
    }
    __syncwarp();
    if (w < 63) {
#pragma unroll 1
      for (int k = 0; k < 4; k++) p = quad_dbl(p, j);
    }
  }
}

// Pass B: thread t = 64 * v + w fills entries 2..15 of window w of validator v.
__global__ void __launch_bounds__(kThreads)
    windows_kernel(int16_t *__restrict__ out,  // [V*64*16, 4, 20], entries 0-1 set
                   int n_windows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_windows) return;
  int16_t *entry = out + (size_t)80 * 16 * t;
  ge m;
  ge_cached p;
  entry_load(m, entry + 80);
  ge_to_cached(p, m);
#pragma unroll 1
  for (int d = 2; d < 16; d++) {
    ge_add_cached(m, m, p);
    entry_store(entry + 80 * d, m);
  }
}

// Kernel 3: quad q of a signature's kSumQuads sums windows
// kSumWindows * q ... kSumWindows * (q + 1) - 1 of both halves; lane j owns
// coordinate j.  Then one thread per signature finishes.
__global__ void __launch_bounds__(kSumThreads)
    tabulated_kernel(const int16_t *__restrict__ tables,  // [V*64*16, 4, 20]
                     const int32_t *__restrict__ idx,     // [B]
                     const uint8_t *__restrict__ h_le,    // [B, 32]
                     const uint8_t *__restrict__ s_le,    // [B, 32]
                     const int16_t *__restrict__ r_y,     // [B, 20]
                     const uint8_t *__restrict__ r_sign,  // [B]
                     const int32_t *__restrict__ base_madd,  // [64*16, 3, 20]
                     uint8_t *__restrict__ ok, uint8_t *__restrict__ r_out,
                     int n_rows, int batch) {
  const int t = blockIdx.x * kSumThreads + threadIdx.x;
  const int j = t & 3;
  const int quad = (t >> 2) % kSumQuads;
  const int i = t / kSumLanes;
  const bool live = i < batch;
  const int ic = live ? i : batch - 1;  // clamp: the lanes run, store nothing
  int row = idx[ic];
  if (row < 0 || row >= n_rows) row = 0;  // callers clip; never fault
  const uint8_t *h = h_le + 32 * (size_t)ic;
  const uint8_t *s = s_le + 32 * (size_t)ic;
  const int16_t *vt = tables + (size_t)80 * 16 * 64 * row;
  const int bj = j < 3 ? j : 2;  // lane 3 passes any madd coordinate
  const int w0 = kSumWindows * quad, w_end = w0 + kSumWindows;

  fe acc = quad_identity(j);
  quad_row next = quad_row_fetch(vt + 80 * (16 * w0 + scalar_digit(h, w0)), j);
#pragma unroll 1
  for (int w = w0; w < w_end; w++) {
    // base entry s_w (L2-resident), then the table row of window w + 1
    // (the last window fetches its own again) ahead of this window's adds
    const uint4 *bsrc = reinterpret_cast<const uint4 *>(
        base_madd + 20 * (3 * (16 * w + scalar_digit(s, w)) + bj));
    uint32_t bw[20];
#pragma unroll
    for (int k = 0; k < 5; k++) {
      const uint4 u = __ldg(bsrc + k);
      bw[4 * k] = u.x;
      bw[4 * k + 1] = u.y;
      bw[4 * k + 2] = u.z;
      bw[4 * k + 3] = u.w;
    }
    fe row_w;
    fe_from13(row_w, next);
    const int wn = w + 1 < w_end ? w + 1 : w;
    next = quad_row_fetch(vt + 80 * (16 * wn + scalar_digit(h, wn)), j);
    acc = quad_add(acc, quad_cached(row_w, j), j);
    fe b;
    fe_from13(b, bw);
    acc = quad_madd(acc, b, j);
  }
  // fold the other quads' sums in (one add for a pair)
#pragma unroll
  for (int m = 4; m < kSumLanes; m *= 2) acc = quad_add(acc, quad_cached(fe_shfl_xor(acc, m), j), j);

  // The finish runs once per signature, on one thread: quad 0 leaves X, Y,
  // Z in shared memory, and the block's first kSumSigs threads each take
  // one signature.  No shuffle follows.
  __shared__ fe xyz[kSumSigs][3];
  if (quad == 0 && j < 3) xyz[threadIdx.x / kSumLanes][j] = acc;
  __syncthreads();
  const int f = blockIdx.x * kSumSigs + threadIdx.x;
  if (threadIdx.x >= kSumSigs || f >= batch) return;
  const fe *p = xyz[threadIdx.x];
  fe zinv, x, y;
  fe_invert(zinv, p[2]);
  fe_mul(x, p[0], zinv);
  fe_mul(y, p[1], zinv);
  fe_canon(x);
  fe_canon(y);
  finish_affine(x, y, r_y + 20 * (size_t)f, r_sign[f], ok + f,
                r_out != nullptr ? r_out + 32 * (size_t)f : nullptr);
}

// The grid of each launch, by `which`: pass A (0) and pass B (1) of a build
// of n validators, kernel 3 (2) for n signatures.  The launches and the
// exports below all take it from here.
struct Grid {
  int blocks, threads;
};

Grid grid(int which, int n) {
  if (which == 0) return {(n + kChainQuads - 1) / kChainQuads, kChainThreads};
  if (which == 1) return {(64 * n + kThreads - 1) / kThreads, kThreads};  // per (validator, window)
  return {(kSumLanes * n + kSumThreads - 1) / kSumThreads, kSumThreads};
}

}  // namespace

extern "C" int ed25519_window_tables_launch(const void *rows, void *out, int n_rows,
                                            void *stream) {
  const Grid a = grid(0, n_rows), b = grid(1, n_rows);
  chain_kernel<<<a.blocks, a.threads, 0, (cudaStream_t)stream>>>((const int16_t *)rows,
                                                                 (int16_t *)out, n_rows);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  windows_kernel<<<b.blocks, b.threads, 0, (cudaStream_t)stream>>>((int16_t *)out, 64 * n_rows);
  return (int)cudaGetLastError();
}

// threads launched for n (see grid) by pass A (0), pass B (1) or kernel 3 (2)
extern "C" int ed25519_table_threads(int which, int n) {
  const Grid g = grid(which, n);
  return g.blocks * g.threads;
}

// warps that one SM holds at once (occupancy calculator) of pass A (0),
// pass B (1) or kernel 3 (2)
extern "C" int ed25519_table_resident_warps(int which) {
  int blocks = 0;
  const int threads = grid(which, 1).threads;
  cudaError_t rc;
  if (which == 0)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chain_kernel, threads, 0);
  else if (which == 1)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, windows_kernel, threads, 0);
  else
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tabulated_kernel, threads, 0);
  return rc == cudaSuccess ? blocks * threads / 32 : -1;
}

extern "C" int ed25519_tabulated_launch(const void *tables, const void *idx, const void *h_le,
                                        const void *s_le, const void *r_y, const void *r_sign,
                                        const void *base_madd, void *ok, void *r_out,
                                        int n_rows, int batch, void *stream) {
  const Grid g = grid(2, batch);
  tabulated_kernel<<<g.blocks, g.threads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const int32_t *)idx, (const uint8_t *)h_le,
      (const uint8_t *)s_le, (const int16_t *)r_y, (const uint8_t *)r_sign,
      (const int32_t *)base_madd, (uint8_t *)ok, (uint8_t *)r_out, n_rows, batch);
  return (int)cudaGetLastError();
}
