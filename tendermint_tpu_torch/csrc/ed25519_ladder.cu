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
// table and a 265-op inversion: about 2.15k field multiplies of 25
// 64x64->128 products and 1.3k squarings of 15, against 392 bytes of input.
// Nothing here is memory-bound.
//
// Design: one thread per signature, blocks of 128.  Field elements are five
// 64-bit limbs (fe51.cuh) so each product is one native 64-bit multiply pair
// instead of the 13-bit int32 convolution the TPU needed.  The thread gathers
// its own pubkey row by index (the fused indexed path is one launch),
// expands the packed little-endian h/s bytes into digits in place, builds
// its 16-entry d*(-A) table in local memory, and reads the fixed-base madd
// table from shared memory (16 x 3 field elements, converted once per
// block).  There is no data-dependent early exit: every lane does the same
// work, so the tabulated-vs-ladder profile may time it on zero inputs.
#include <cuda_runtime.h>

#include "fe51.cuh"

namespace {

constexpr int kThreads = 128;

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
  __shared__ fe base[16][3];
  for (int e = threadIdx.x; e < 48; e += blockDim.x)
    fe_from13(base[e / 3][e % 3], base_table + 20 * e);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  int row = idx[i];
  if (row < 0 || row >= n_rows) row = 0;  // callers clip; never fault

  ge tab[16];
  ge_identity(tab[0]);
  ge_from13(tab[1], rows + 80 * (size_t)row);
  for (int d = 2; d < 16; d++) {
    if (d % 2 == 0)
      ge_double(tab[d], tab[d / 2]);
    else
      ge_add(tab[d], tab[d - 1], tab[1]);
  }

  const uint8_t *h = h_le + 32 * (size_t)i;
  const uint8_t *s = s_le + 32 * (size_t)i;
  ge acc;
  ge_identity(acc);
  for (int w = 63; w >= 0; w--) {  // most significant window first
    for (int k = 0; k < 4; k++) ge_double(acc, acc);
    ge_add(acc, acc, tab[scalar_digit(h, w)]);
    const int sd = scalar_digit(s, w);
    ge_madd(acc, acc, base[sd][0], base[sd][1], base[sd][2]);
  }
  ge_finish(acc, r_y + 20 * (size_t)i, r_sign[i], ok + i,
            r_out != nullptr ? r_out + 32 * (size_t)i : nullptr);
}

}  // namespace

extern "C" int ed25519_ladder_launch(const void *rows, const void *idx, const void *h_le,
                                     const void *s_le, const void *r_y, const void *r_sign,
                                     const void *base_table, void *ok, void *r_out,
                                     int n_rows, int batch, void *stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  ladder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)rows, (const int32_t *)idx, (const uint8_t *)h_le,
      (const uint8_t *)s_le, (const int16_t *)r_y, (const uint8_t *)r_sign,
      (const int32_t *)base_table, (uint8_t *)ok, (uint8_t *)r_out, n_rows, batch);
  return (int)cudaGetLastError();
}
