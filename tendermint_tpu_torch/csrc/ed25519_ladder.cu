// Kernel 1: batched cofactorless ed25519 verification, windowed Straus
// ladder, with the pubkey-row gather fused in.
//
// Replaces: tendermint_tpu/ops/ed25519_pallas.py verify_prepared_pallas ->
// _kernel (the Pallas TPU ladder), and the fused jnp.take gather of
// tendermint_tpu/crypto/batch_verifier.py _shared_fused_jit.  Plain version:
// ops/ed25519.py verify_prepared_packed.
//
// What bounds it on the H100: integer multiply throughput.  Per signature
// the ladder does 64 x (4 doublings + 1 add + 1 madd) plus the 14-op d*(-A)
// table, its 16 cached conversions and a 267-op finish: about 72k 64x64->128
// products against 392 bytes of input.  Nothing here is memory-bound.  What
// held the one-thread-per-signature design back was latency, not that rate:
// each thread walked a 73k-product chain of dependent multiplies, with 2.4
// warps per SM at B = 10,000 to hide it.
//
// Design: one quad (four lanes) per signature, 8 signatures per warp, 16 per
// block of 64 threads (42.9 KB of shared memory, under the 48 KB default:
// five blocks, 10 warps, fit an SM; 32 signatures per block would fit two,
// 8 warps).  Lane j carries coordinate j of every point and runs
// one field operation per stage of each formula (ge_quad.cuh), which cuts
// each lane's chain to about 22k products and gives 4x the warps (9.5 per SM
// at B = 10,000).  The d*(-A) table lives in shared memory, 16 entries of
// 4 coordinates per signature in the cached form (Y-X, Y+X, 2d*T, Z) that
// the add's first stage reads; lane j reads and writes only coordinate j,
// so the table needs no barrier.  It is built in place: extended entries
// first (7 doublings, 7 adds), then each converted to the cached form.  The
// fixed-base madd table is converted once per block into shared memory.
// The finish (inversion, then x and y) runs on all four lanes of the quad
// alike (quad_finish); the inversion stays out of line, and the operands it
// takes by reference are the kernel's whole stack frame (inlining it removed
// the frame but did not make the kernel faster).  Lanes of a quad past
// `batch` compute on the last signature's inputs and store nothing, so
// every shuffle has its full warp.
// There is no data-dependent early exit: every lane does the same work, so
// the tabulated-vs-ladder profile may time it on zero inputs.
//
// ed25519_quad_selftest_launch holds the quad helpers against the one-lane
// helpers of fe51.cuh (chip_smoke.py phase 2); it is no part of the path.
#include <cuda_runtime.h>

#include <mutex>

#include "ge_quad.cuh"

namespace {

constexpr int kSigsPerBlock = 16;
constexpr int kThreads = 4 * kSigsPerBlock;
// base madd table (16 x 3) + per signature 16 cached entries x 4 coordinates
constexpr int kSharedFe = 48 + kSigsPerBlock * 64;
constexpr size_t kSharedBytes = kSharedFe * sizeof(fe);
// under the 48 KB that a launch may take without opting in
static_assert(kSharedBytes <= 48 * 1024, "ladder shared memory needs the opt-in attribute");

// blocks the ladder launches for `batch` signatures
int ladder_blocks(int batch) { return (batch + kSigsPerBlock - 1) / kSigsPerBlock; }

__global__ void __launch_bounds__(kThreads)
    ladder_kernel(const int16_t *__restrict__ rows,   // [V, 4, 20] -A
                  const int32_t *__restrict__ idx,    // [B] row per signature
                  const uint8_t *__restrict__ h_le,   // [B, 32] h mod L, LE
                  const uint8_t *__restrict__ s_le,   // [B, 32] s, LE
                  const int16_t *__restrict__ r_y,    // [B, 20] raw R y limbs
                  const uint8_t *__restrict__ r_sign, // [B] R x-parity bit
                  const int32_t *__restrict__ base_table,  // [16, 3, 20] madd form
                  uint8_t *__restrict__ ok,           // [B]
                  uint8_t *__restrict__ r_out,        // [B, 32] or null
                  int n_rows, int batch) {
  extern __shared__ fe shared[];
  fe *base = shared;  // [16][3]
  for (int e = threadIdx.x; e < 48; e += blockDim.x) fe_from13(base[e], base_table + 20 * e);
  __syncthreads();

  const int j = threadIdx.x & 3;
  const int sig = threadIdx.x >> 2;
  const int i = blockIdx.x * kSigsPerBlock + sig;
  const bool live = i < batch;
  const int ic = live ? i : batch - 1;  // clamp: the quad runs, stores nothing
  fe *tab = shared + 48 + 64 * sig;      // [16][4], lane j uses [d][j]
  int row = idx[ic];
  if (row < 0 || row >= n_rows) row = 0;  // callers clip; never fault

  fe a;
  fe_from13(a, rows + 80 * (size_t)row + 20 * j);
  tab[j] = quad_identity(j);
  tab[4 + j] = a;
  const fe a_cached = quad_cached(a, j);
  fe p = a;
  for (int d = 2; d < 16; d++) {  // d uniform across the warp: no divergence
    if (d % 2 == 0)
      p = quad_dbl(tab[4 * (d / 2) + j], j);
    else
      p = quad_add(p, a_cached, j);
    tab[4 * d + j] = p;
  }
  for (int d = 0; d < 16; d++) tab[4 * d + j] = quad_cached(tab[4 * d + j], j);

  const uint8_t *h = h_le + 32 * (size_t)ic;
  const uint8_t *s = s_le + 32 * (size_t)ic;
  const int bj = j < 3 ? j : 2;
  fe acc = quad_identity(j);
  for (int w = 63; w >= 0; w--) {  // most significant window first
#pragma unroll 1
    for (int k = 0; k < 4; k++) acc = quad_dbl(acc, j);
    acc = quad_add(acc, tab[4 * scalar_digit(h, w) + j], j);
    acc = quad_madd(acc, base[3 * scalar_digit(s, w) + bj], j);
  }
  quad_finish(acc, j, live, r_y + 20 * (size_t)ic, r_sign[ic], ok + ic,
              r_out != nullptr ? r_out + 32 * (size_t)ic : nullptr);
}

// For each item i: P = 2*P0 and Q = 2*Q0 from rows (general Z), then
// out[0] = one-lane (ge_double(P), ge_add(P, Q), ge_madd(P, base[digit]))
// and out[1] = the quad forms, as raw radix-2^51 limbs and canonical 13-bit
// limbs.
__global__ void __launch_bounds__(128)
    quad_selftest_kernel(const int16_t *__restrict__ p_rows,  // [n, 4, 20]
                         const int16_t *__restrict__ q_rows,  // [n, 4, 20]
                         const uint8_t *__restrict__ digits,  // [n]
                         const int32_t *__restrict__ base_table,  // [16, 3, 20]
                         u64 *__restrict__ raw,       // [2, n, 3, 4, 5]
                         int16_t *__restrict__ canon, // [2, n, 3, 4, 20]
                         int n) {
  const int j = threadIdx.x & 3;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const bool live = i < n;
  const int ic = live ? i : n - 1;
  ge p0, q0, p, q, one[3];
  ge_from13(p0, p_rows + 80 * (size_t)ic);
  ge_from13(q0, q_rows + 80 * (size_t)ic);
  ge_double(p, p0);
  ge_double(q, q0);
  fe m[3];
  for (int k = 0; k < 3; k++) fe_from13(m[k], base_table + 20 * (3 * (digits[ic] & 15) + k));
  ge_double(one[0], p);
  ge_add(one[1], p, q);
  ge_madd(one[2], p, m[0], m[1], m[2]);

  const fe pj = ge_coord(p, j);
  fe quad[3];
  quad[0] = quad_dbl(pj, j);
  quad[1] = quad_add(pj, quad_cached(ge_coord(q, j), j), j);
  quad[2] = quad_madd(pj, fe_sel(j == 0, m[0], fe_sel(j == 1, m[1], m[2])), j);
  if (!live) return;  // after the last shuffle
  for (int op = 0; op < 3; op++) {
    const fe got[2] = {ge_coord(one[op], j), quad[op]};
    for (int which = 0; which < 2; which++) {
      const size_t slot = ((size_t)which * n + i) * 3 + op;
      for (int l = 0; l < 5; l++) raw[(slot * 4 + j) * 5 + l] = got[which].v[l];
      fe_to13(canon + (slot * 4 + j) * 20, got[which]);
    }
  }
}

// The ladder's shared-memory carveout on the current device: set at its
// first call there (kMaxDevices slots; a device past them sets it on every
// call), its result kept for later calls.
constexpr int kMaxDevices = 64;
std::once_flag carveout_once[kMaxDevices];
cudaError_t carveout_rc[kMaxDevices];

cudaError_t set_carveout() {
  return cudaFuncSetAttribute(ladder_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

cudaError_t ladder_carveout() {
  int dev = 0;
  const cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return set_carveout();
  std::call_once(carveout_once[dev], [dev] { carveout_rc[dev] = set_carveout(); });
  return carveout_rc[dev];
}

}  // namespace

extern "C" int ed25519_ladder_launch(const void *rows, const void *idx, const void *h_le,
                                     const void *s_le, const void *r_y, const void *r_sign,
                                     const void *base_table, void *ok, void *r_out,
                                     int n_rows, int batch, void *stream) {
  // the most shared memory per SM, so that five blocks of 16 signatures fit;
  // a function attribute holds for the current device only, so it is set
  // once per device, on the first launch there
  const cudaError_t carveout = ladder_carveout();
  if (carveout != cudaSuccess) return (int)carveout;
  ladder_kernel<<<ladder_blocks(batch), kThreads, kSharedBytes, (cudaStream_t)stream>>>(
      (const int16_t *)rows, (const int32_t *)idx, (const uint8_t *)h_le,
      (const uint8_t *)s_le, (const int16_t *)r_y, (const uint8_t *)r_sign,
      (const int32_t *)base_table, (uint8_t *)ok, (uint8_t *)r_out, n_rows, batch);
  return (int)cudaGetLastError();
}

// threads the ladder launches for `batch` signatures
extern "C" int ed25519_ladder_threads(int batch) { return ladder_blocks(batch) * kThreads; }

// warps of the ladder that one SM holds at once (occupancy calculator)
extern "C" int ed25519_ladder_resident_warps() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ladder_kernel, kThreads,
                                                    kSharedBytes) != cudaSuccess)
    return -1;
  return blocks * kThreads / 32;
}

extern "C" int ed25519_quad_selftest_launch(const void *p_rows, const void *q_rows,
                                            const void *digits, const void *base_table,
                                            void *raw, void *canon, int n, void *stream) {
  const int blocks = (4 * n + 127) / 128;
  quad_selftest_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      (const int16_t *)p_rows, (const int16_t *)q_rows, (const uint8_t *)digits,
      (const int32_t *)base_table, (u64 *)raw, (int16_t *)canon, n);
  return (int)cudaGetLastError();
}
