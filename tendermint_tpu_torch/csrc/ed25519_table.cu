// Kernels 2 and 3: per-validator window tables and the zero-doubling
// tabulated verify.
//
//   table[v, w, d] = d * 16^w * (-A_v)      (w = 0..63, d = 0..15)
//   R' = sum_w table[idx, w, h_w] + sum_w base[w, s_w]     (128 point adds)
//
// Kernel 2 (window_tables_kernel) replaces the XLA lax.scan
// tendermint_tpu/ops/ed25519_table.py _build_tables_jit; plain version
// ops/ed25519_table.py build_window_tables_plain.  Bound on the H100:
// integer multiply throughput (64 x (14 adds + 4 doublings) per validator
// plus 4096 canonicalizations), with 160 KB written per validator.  Design:
// one thread per validator walks its 64 windows, keeps the running point
// 16^w * (-A) in registers, and writes every entry as canonical int16 13-bit
// limbs in the JAX layout [V*64*16, 4, 20], bit-identical to the JAX build,
// so tables carry across between the two packages.
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

#include "fe51.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void ge_store13(int16_t *out, const ge &p) {
  fe_to13(out, p.X);
  fe_to13(out + 20, p.Y);
  fe_to13(out + 40, p.Z);
  fe_to13(out + 60, p.T);
}

__global__ void __launch_bounds__(kThreads)
    window_tables_kernel(const int16_t *__restrict__ rows,  // [V, 4, 20] -A
                         int16_t *__restrict__ out,         // [V*64*16, 4, 20]
                         int n_rows) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_rows) return;
  ge p, m, id;
  ge_identity(id);
  ge_from13(p, rows + 80 * (size_t)v);
  for (int w = 0; w < 64; w++) {
    int16_t *entry = out + (size_t)80 * 16 * (64 * (size_t)v + w);
    ge_store13(entry, id);
    ge_store13(entry + 80, p);
    m = p;
    for (int d = 2; d < 16; d++) {
      ge_add(m, m, p);
      ge_store13(entry + 80 * d, m);
    }
    for (int k = 0; k < 4; k++) ge_double(p, p);
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

}  // namespace

extern "C" int ed25519_window_tables_launch(const void *rows, void *out, int n_rows,
                                            void *stream) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  window_tables_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)rows, (int16_t *)out, n_rows);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_tabulated_launch(const void *tables, const void *idx, const void *h_le,
                                        const void *s_le, const void *r_y, const void *r_sign,
                                        const void *base_windows, void *ok, void *r_out,
                                        int n_rows, int batch, void *stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  tabulated_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const int32_t *)idx, (const uint8_t *)h_le,
      (const uint8_t *)s_le, (const int16_t *)r_y, (const uint8_t *)r_sign,
      (const int32_t *)base_windows, (uint8_t *)ok, (uint8_t *)r_out, n_rows, batch);
  return (int)cudaGetLastError();
}
