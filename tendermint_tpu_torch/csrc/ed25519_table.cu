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
// table-row bytes -- 64 random 160-byte int16 rows per signature from the
// validator tables (205 MB for a 10k commit) plus 64 rows from the 320 KB
// base-window table (13-bit int32 limbs, converted on load as kernel 1 does
// its madd table), which stays in L2.  Design: one thread per signature
// reads its 64 table rows straight from global memory by index (no
// materialized gather, no relayout), sums them with the complete add, then
// inverts, canonicalizes and compares as kernel 1 does.  The TPU kernel
// carried its accumulator across a sequential grid axis in VMEM; here the
// 128-step sum is a loop inside the thread.
#include <cuda_runtime.h>

#include "ge_quad.cuh"

namespace {

constexpr int kThreads = 128;      // kernel 3 and pass B
constexpr int kChainQuads = 16;    // pass A: validators per block of 64
constexpr int kChainThreads = 4 * kChainQuads;

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

__global__ void __launch_bounds__(kThreads)
    tabulated_kernel(const int16_t *__restrict__ tables,  // [V*64*16, 4, 20]
                     const int32_t *__restrict__ idx,     // [B]
                     const uint8_t *__restrict__ h_le,    // [B, 32]
                     const uint8_t *__restrict__ s_le,    // [B, 32]
                     const int16_t *__restrict__ r_y,     // [B, 20]
                     const uint8_t *__restrict__ r_sign,  // [B]
                     const int32_t *__restrict__ base_windows,  // [64*16, 4, 20]
                     uint8_t *__restrict__ ok, uint8_t *__restrict__ r_out,
                     int n_rows, int batch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  int row = idx[i];
  if (row < 0 || row >= n_rows) row = 0;  // callers clip; never fault
  const uint8_t *h = h_le + 32 * (size_t)i;
  const uint8_t *s = s_le + 32 * (size_t)i;
  const int16_t *vt = tables + (size_t)80 * 16 * 64 * row;
  ge acc, q;
  ge_identity(acc);
  for (int w = 0; w < 64; w++) {
    ge_from13(q, vt + 80 * (16 * w + scalar_digit(h, w)));
    ge_add(acc, acc, q);
  }
  for (int w = 0; w < 64; w++) {
    ge_from13(q, base_windows + 80 * (16 * w + scalar_digit(s, w)));
    ge_add(acc, acc, q);
  }
  ge_finish(acc, r_y + 20 * (size_t)i, r_sign[i], ok + i,
            r_out != nullptr ? r_out + 32 * (size_t)i : nullptr);
}

// The grid of each launch, by `which`: pass A (0) and pass B (1) of a build
// of n validators, kernel 3 (2) for n signatures.  The launches and the
// exports below all take it from here.
struct Grid {
  int blocks, threads;
};

Grid grid(int which, int n) {
  if (which == 0) return {(n + kChainQuads - 1) / kChainQuads, kChainThreads};
  if (which == 1) n *= 64;  // one thread per (validator, window)
  return {(n + kThreads - 1) / kThreads, kThreads};
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
                                        const void *base_windows, void *ok, void *r_out,
                                        int n_rows, int batch, void *stream) {
  const Grid g = grid(2, batch);
  tabulated_kernel<<<g.blocks, g.threads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const int32_t *)idx, (const uint8_t *)h_le,
      (const uint8_t *)s_le, (const int16_t *)r_y, (const uint8_t *)r_sign,
      (const int32_t *)base_windows, (uint8_t *)ok, (uint8_t *)r_out, n_rows, batch);
  return (int)cudaGetLastError();
}
