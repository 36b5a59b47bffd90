// The batched BLS12-381 point fold: the sum of a bucket of Jacobian G1 (over
// Fp) or G2 (over Fp2) points as a binary tree of complete additions.
//
// Replaces the plain-JAX (jit, not Pallas) tree of
// tendermint_tpu/crypto/bls/jax_tier.py: _tree (:223) with g1_padd behind
// aggregate_g1 (:300) and with g2_padd behind aggregate_g2 (:327).  Plain
// version: ops/bls12_381_fold.py fold_plain; wrappers fold_g1 / fold_g2.
//
// Rows in and out keep the JAX layout: each Fp element is 48 8-bit limbs in
// int32, in Montgomery form with R = 2^384; a G1 point is [3][48] (X, Y, Z),
// a G2 point [3][2][48]; the identity is the all-zero row (Z = 0).  The
// kernels compute in radix 2^32: 12 limbs per Fp element, CIOS Montgomery
// with the same R, so every canonical value equals JAX's whatever the
// radix.  Every field result is canonical (< P) after one conditional
// subtraction, as in JAX: the same-x and same-y tests compare limbs, and
// any formula for the same field value gives the same limbs.
//
// The addition is jax_tier's _make_point_add: add-2007-bl, and dbl-2009-l
// where it is selected; per pair Z1 = 0 gives Q, Z2 = 0 gives P, the same x
// and y the double, the same x alone the all-zero point.
//
// Design.  The tree is 14 additions deep at 10,000 points and its top
// levels hold a pair or two, so the fold is as fast as one addition's
// latency allows, and one warp issues integer instructions at one every
// two clocks: what counts is the instructions on a lane's path, ~1,200 for
// a field multiply.  So several lanes add one pair, each one multiply a
// stage, the products of a stage independent, and the stages few.
//
// G1: eight lanes a pair (four pairs a warp).  A G1 point in shared memory
// carries Z^2 and Z^3 beside X, Y, Z (Chudnovsky's coordinates; the rows'
// points gain them at level 0, two multiplies a point), so add-2007-bl
// takes three stages:
//
//   slot  stage 1             stage 2               stage 3
//   0     U1 = X1 Z2^2        H H                   H H (U1 + U2)
//   1     U2 = X2 Z1^2        r r                   -
//   2     S1 = Y1 Z2^3        S1 H                  -
//   3     S2 = Y2 Z1^3        r (2 U1 + U2)         y H H
//   4     B = Z1^2 Z2^2       B H                   B H H
//   5     C = Z1^3 Z2^3       C H                   C H H H
//   6     A = Z1 Z2           A H                   -
//   7     (A again)           (r r again)           r r r
//
// with H = U2 - U1, r = 2 (S2 - S1) and the same-x and same-y tests after
// stage 1, y = r (2 U1 + U2) - 2 S1 H after stage 2, and then X3 = r^2 -
// 4 H^2 (U1 + U2), Y3 = 4 y H^2 - r^3, Z3 = 2 A H, Z3^2 = 4 B H^2, Z3^3 =
// 8 C H^3: with I = 4 H^2, J = H I and V = U1 I these are add-2007-bl's
// X3 = r^2 - J - 2V, Y3 = r (V - X3) - 2 S1 J and Z3 = 2 Z1 Z2 H, the same
// field values and so the same limbs.  The writer of coordinate j is slot j.
//
// G2: twelve lanes a pair (a group of 16 lanes, two pairs a warp; lanes
// 12-15 mirror lanes 9-11 and write nothing), points X, Y, Z.  Each of the
// pair's four slots does one Fp2 multiply a stage as three lanes, one
// Karatsuba product each (a0 b0, a1 b1, (a0 + a1)(b0 + b1)).  add-2007-bl
// in five stages over X, Y, Z (a G2 lane already holds 255 registers):
//
//   stage   slot 0            slot 1            slot 2          slot 3
//   1       Z1Z1 = Z1^2       Z2Z2 = Z2^2       Y1 Z2           Y2 Z1
//   2       U1 = X1 Z2Z2      U2 = X2 Z1Z1      S1 = Y1Z2 Z2Z2  S2 = Y2Z1 Z1Z1
//             then H = U2 - U1, r = 2 (S2 - S1), same_x, same_y on every lane
//   3       H^2               r^2               Z1 Z2           (r^2 again)
//             then I = 4 H^2
//   4       J = H I           V = U1 I          Z1Z2 H          (unused)
//             then X3 = r^2 - J - 2V
//   5       r (V - X3)        S1 J              (unused)        (unused)
//             then Y3 = r (V - X3) - 2 S1 J, Z3 = 2 Z1Z2 H
//
// The G2 stages are a loop around one multiply, so that the code of a pair
// addition fits the instruction cache.  Operands move within the pair's
// lanes by __shfl_sync with the full mask; lanes differ by operand and
// select, never by a branch around a shuffle (ge_quad.cuh's rule).
// dbl-2009-l runs in three stages (X1^2, Y1^2, Y1 Z1, and for G1 Y1 Z1^3;
// then B^2, (X1 + B)^2, E^2, and for G1 B Z1^2 and B Y1 Z1^3; then
// E (D - X3)) and only when some live pair of the warp needs it
// (__any_sync, a warp-uniform branch).  Field elements stay in registers:
// no __noinline__ call, no stack.  The field adds, subtractions and
// multiplies are PTX carry chains (one instruction a word or a half
// product, where C's 64-bit sums take three or four).  The G1 stages are
// a loop around one multiply too: with three inlined copies G1 took 0.128
// ms against 0.111 at 10,000 points (fold_trial.py, NVIDIA H100 80GB HBM3).
//
// The tree: one launch.  A block folds an aligned subtree of leaves[0]
// points (128) in shared memory, one level after another with
// __syncthreads() between them (at stride s, pair t adds the points at
// 2 s t and 2 s t + s into the first), and writes its sum; the block that
// completes a group of leaves[1] sums (16; an atomic counter after
// __threadfence()) folds them the same way, and so on.  At 10,000 points
// (bucket 16,384) 128 blocks fold 128 points each, the 8 blocks that
// complete a group of 16 sums fold those, and the one that completes the 8
// folds them.  The plan comes from ops/bls12_381_fold.py plan().  An aligned
// subtree of _tree's perfect binary tree is exactly what its first levels
// compute there (the point at i, i % 2^(s+1) == 0, becomes cur[i] +
// cur[i + 2^s], the lower index on the left), and the block sums in block
// order are its next level, so the association, and every limb, stay
// JAX's.
//
// Bound on the H100: integer multiply throughput, for the work the sum
// needs (not the work this design does).  A 12-limb CIOS multiply is 144
// (a x b) + 144 (m x P) 32x32->64 partial products and 12 32-bit products
// for m: 300; a squaring 78 + 144 + 12 = 234.  An Fp2 multiply is 3 Fp
// multiplies (Karatsuba), an Fp2 squaring 2.  A pair of distinct finite
// points needs add-2007-bl's 12 multiplies and 4 squarings: 4,536
// products for G1, 13,200 for G2; a pair of equal points the same-x and
// same-y test and dbl-2009-l (8 multiplies, 7 squarings); a pair with the
// identity none.  B distinct points need B - 1 additions: at B = 10,000
// 45.4 M and 132.0 M products, ~2.7 and ~7.9 us at the 16.75 T/s that
// chip_smoke.py assumes, against ~1.7 and ~3.4 us for the rows' bytes.
// The tree's depth, 14 additions of three (G1) or five (G2) multiply
// stages each, keeps the kernels above the bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLimbs = 12;
constexpr int kG1Threads = 256;  // 32 groups of 8 lanes
constexpr int kG2Threads = 256;  // 16 groups of 16 lanes
constexpr int kMaxLeaves = 512;
constexpr unsigned kFull = 0xffffffffu;

// P, little-endian 32-bit limbs, and -P^-1 mod 2^32
__constant__ uint32_t kP[kLimbs] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
constexpr uint32_t kN0 = 0xfffcfffdu;

struct Fp {
  uint32_t v[kLimbs];
};

struct Fp2 {
  Fp c0, c1;
};

// ---------------------------------------------------------------- Fp ----

// Multi-word sums run as PTX carry chains (add.cc / addc, mad.lo.cc /
// madc.hi.cc): one instruction a word or a half product, where C's 64-bit
// sums take three or four.  One warp issues integer instructions at one
// every two clocks, so their count sets the latency of the tree's serial
// levels.  Each chain is one asm statement: the carry flag never crosses
// statements.  P's words are the chains' immediates.

#define LIMBS12(c, x) \
  c(x[0]), c(x[1]), c(x[2]), c(x[3]), c(x[4]), c(x[5]), c(x[6]), c(x[7]), c(x[8]), c(x[9]), \
      c(x[10]), c(x[11])

// x -= P over 12 words; returns the borrow as 0 or 0xffffffff
__device__ __forceinline__ uint32_t sub_p(uint32_t x[kLimbs]) {
  uint32_t borrow;
  asm("sub.cc.u32 %0, %0, 0xffffaaab; subc.cc.u32 %1, %1, 0xb9feffff;\n\t"
      "subc.cc.u32 %2, %2, 0xb153ffff; subc.cc.u32 %3, %3, 0x1eabfffe;\n\t"
      "subc.cc.u32 %4, %4, 0xf6b0f624; subc.cc.u32 %5, %5, 0x6730d2a0;\n\t"
      "subc.cc.u32 %6, %6, 0xf38512bf; subc.cc.u32 %7, %7, 0x64774b84;\n\t"
      "subc.cc.u32 %8, %8, 0x434bacd7; subc.cc.u32 %9, %9, 0x4b1ba7b6;\n\t"
      "subc.cc.u32 %10, %10, 0x397fe69a; subc.cc.u32 %11, %11, 0x1a0111ea;\n\t"
      "subc.u32 %12, 0, 0;\n\t"
      : LIMBS12("+r", x), "=r"(borrow));
  return borrow;
}

// x += P over 12 words, modulo 2^384
__device__ __forceinline__ void add_p(uint32_t x[kLimbs]) {
  asm("add.cc.u32 %0, %0, 0xffffaaab; addc.cc.u32 %1, %1, 0xb9feffff;\n\t"
      "addc.cc.u32 %2, %2, 0xb153ffff; addc.cc.u32 %3, %3, 0x1eabfffe;\n\t"
      "addc.cc.u32 %4, %4, 0xf6b0f624; addc.cc.u32 %5, %5, 0x6730d2a0;\n\t"
      "addc.cc.u32 %6, %6, 0xf38512bf; addc.cc.u32 %7, %7, 0x64774b84;\n\t"
      "addc.cc.u32 %8, %8, 0x434bacd7; addc.cc.u32 %9, %9, 0x4b1ba7b6;\n\t"
      "addc.cc.u32 %10, %10, 0x397fe69a; addc.u32 %11, %11, 0x1a0111ea;\n\t"
      : LIMBS12("+r", x));
}

// r = x mod P for x in [0, 2P) (12 limbs: 2P < 2^382)
__device__ __forceinline__ void fp_reduce(Fp &r, const uint32_t x[kLimbs]) {
  uint32_t d[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) d[j] = x[j];
  const uint32_t borrow = sub_p(d);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = borrow ? x[j] : d[j];  // no borrow: x >= P
}

// r = a * b * R^-1 mod P, CIOS: for each word b_i of b, t += a b_i, then
// t += m P with m = t_0 (-P^-1) mod 2^32, which clears t_0, then t /= 2^32
__device__ __forceinline__ void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[kLimbs + 1];
#pragma unroll
  for (int j = 0; j <= kLimbs; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t bi = b.v[i];
    // the low halves of a_j b_i into t_j (the carry into t_12), then the
    // high halves into t_(j+1): t + a b_i < 2P + 2^32 P < 2^416
    asm("mad.lo.cc.u32 %0, %13, %25, %0; madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2; madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4; madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6; madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8; madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10; madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        : LIMBS12("+r", t), "+r"(t[kLimbs])
        : LIMBS12("r", a.v), "r"(bi));
    asm("mad.hi.cc.u32 %0, %12, %24, %0; madc.hi.cc.u32 %1, %13, %24, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %24, %2; madc.hi.cc.u32 %3, %15, %24, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %24, %4; madc.hi.cc.u32 %5, %17, %24, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %24, %6; madc.hi.cc.u32 %7, %19, %24, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %24, %8; madc.hi.cc.u32 %9, %21, %24, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %24, %10; madc.hi.u32 %11, %23, %24, %11;\n\t"
        : LIMBS12("+r", (t + 1))
        : LIMBS12("r", a.v), "r"(bi));
    const uint32_t m = t[0] * kN0;
    asm("mad.lo.cc.u32 %0, %13, 0xffffaaab, %0; madc.lo.cc.u32 %1, %13, 0xb9feffff, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, 0xb153ffff, %2; madc.lo.cc.u32 %3, %13, 0x1eabfffe, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, 0xf6b0f624, %4; madc.lo.cc.u32 %5, %13, 0x6730d2a0, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, 0xf38512bf, %6; madc.lo.cc.u32 %7, %13, 0x64774b84, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, 0x434bacd7, %8; madc.lo.cc.u32 %9, %13, 0x4b1ba7b6, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, 0x397fe69a, %10; madc.lo.cc.u32 %11, %13, 0x1a0111ea, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        : LIMBS12("+r", t), "+r"(t[kLimbs])
        : "r"(m));
    asm("mad.hi.cc.u32 %0, %12, 0xffffaaab, %0; madc.hi.cc.u32 %1, %12, 0xb9feffff, %1;\n\t"
        "madc.hi.cc.u32 %2, %12, 0xb153ffff, %2; madc.hi.cc.u32 %3, %12, 0x1eabfffe, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, 0xf6b0f624, %4; madc.hi.cc.u32 %5, %12, 0x6730d2a0, %5;\n\t"
        "madc.hi.cc.u32 %6, %12, 0xf38512bf, %6; madc.hi.cc.u32 %7, %12, 0x64774b84, %7;\n\t"
        "madc.hi.cc.u32 %8, %12, 0x434bacd7, %8; madc.hi.cc.u32 %9, %12, 0x4b1ba7b6, %9;\n\t"
        "madc.hi.cc.u32 %10, %12, 0x397fe69a, %10; madc.hi.u32 %11, %12, 0x1a0111ea, %11;\n\t"
        : LIMBS12("+r", (t + 1))
        : "r"(m));
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[j] = t[j + 1];  // t_0 is 0: t /= 2^32, now < 2P
    t[kLimbs] = 0;
  }
  fp_reduce(r, t);
}

// a + b, then one conditional subtraction of P
__device__ __forceinline__ void add(Fp &r, const Fp &a, const Fp &b) {
  uint32_t s[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) s[j] = a.v[j];
  asm("add.cc.u32 %0, %0, %12; addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14; addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16; addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18; addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20; addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22; addc.u32 %11, %11, %23;\n\t"
      : LIMBS12("+r", s)
      : LIMBS12("r", b.v));
  fp_reduce(r, s);  // a + b < 2P < 2^382: no carry out
}

// a - b, and P added back where it borrowed (mod 2^384, into (0, P))
__device__ __forceinline__ void sub(Fp &r, const Fp &a, const Fp &b) {
  uint32_t d[kLimbs], e[kLimbs], borrow;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) d[j] = a.v[j];
  asm("sub.cc.u32 %0, %0, %13; subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15; subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17; subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19; subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21; subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23; subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;\n\t"
      : LIMBS12("+r", d), "=r"(borrow)
      : LIMBS12("r", b.v));
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) e[j] = d[j];
  add_p(e);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = borrow ? e[j] : d[j];
}

__device__ __forceinline__ bool is_zero(const Fp &a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) acc |= a.v[j];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const Fp &a, const Fp &b) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) acc |= a.v[j] ^ b.v[j];
  return acc == 0;
}

__device__ __forceinline__ Fp sel(bool c, const Fp &a, const Fp &b) {
  Fp r;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = c ? a.v[j] : b.v[j];
  return r;
}

// x from lane `src` of the caller's group of `width` lanes
__device__ __forceinline__ Fp shfl(const Fp &x, int src, int width) {
  Fp r;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = __shfl_sync(kFull, x.v[j], src, width);
  return r;
}

// 16-byte shared-memory accesses: coordinates lie at multiples of 48 bytes
__device__ __forceinline__ void load(Fp &r, const uint32_t *p) {
  const uint4 *s = reinterpret_cast<const uint4 *>(p);
#pragma unroll
  for (int k = 0; k < kLimbs / 4; ++k) {
    const uint4 u = s[k];
    r.v[4 * k] = u.x;
    r.v[4 * k + 1] = u.y;
    r.v[4 * k + 2] = u.z;
    r.v[4 * k + 3] = u.w;
  }
}

__device__ __forceinline__ void store(uint32_t *p, const Fp &a) {
  uint4 *s = reinterpret_cast<uint4 *>(p);
#pragma unroll
  for (int k = 0; k < kLimbs / 4; ++k)
    s[k] = make_uint4(a.v[4 * k], a.v[4 * k + 1], a.v[4 * k + 2], a.v[4 * k + 3]);
}

// --------------------------------------------------------------- Fp2 ----

__device__ __forceinline__ void add(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  add(r.c0, a.c0, b.c0);
  add(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void sub(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  sub(r.c0, a.c0, b.c0);
  sub(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ bool is_zero(const Fp2 &a) { return is_zero(a.c0) && is_zero(a.c1); }

__device__ __forceinline__ bool eq(const Fp2 &a, const Fp2 &b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}

__device__ __forceinline__ Fp2 sel(bool c, const Fp2 &a, const Fp2 &b) {
  return Fp2{sel(c, a.c0, b.c0), sel(c, a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 shfl(const Fp2 &x, int src, int width) {
  return Fp2{shfl(x.c0, src, width), shfl(x.c1, src, width)};
}

__device__ __forceinline__ void load(Fp2 &r, const uint32_t *p) {
  load(r.c0, p);
  load(r.c1, p + kLimbs);
}

__device__ __forceinline__ void store(uint32_t *p, const Fp2 &a) {
  store(p, a.c0);
  store(p + kLimbs, a.c1);
}

// ------------------------------------------------------- lane groups ----
//
// A group of lanes adds one pair.  `slot` names the operation a lane does
// in a stage, `from(x, s)` reads x from slot s of the same pair, and the
// writer lanes store coordinate `slot` of the result.  kCoords: the
// coordinates of a point in shared memory.

// G1: eight lanes a pair, slot = lane & 7, one Fp multiply each a stage;
// a point carries X, Y, Z, Z^2 and Z^3 (Chudnovsky's coordinates)
struct OctFp {
  using F = Fp;
  static constexpr int kWidth = 8, kCoords = 5;
  int slot;
  __device__ explicit OctFp(int lane) : slot(lane & 7) {}
  __device__ bool writer() const { return slot < kCoords; }
  __device__ Fp from(const Fp &x, int s) const { return shfl(x, s, kWidth); }
};

using G1Lanes = OctFp;

// G2: twelve lanes of a group of 16; lane g < 12 is product k = g % 3 of
// slot g / 3, lanes 12-15 repeat lanes 9-12 (slot 3, k = (g - 3) % 3); a
// point is X, Y, Z.  `mul` and `sqr` leave the whole product on every lane
// of the slot.
struct KaratsubaFp2 {
  using F = Fp2;
  static constexpr int kWidth = 16, kCoords = 3;
  int slot, k, g;
  __device__ explicit KaratsubaFp2(int lane) : g(lane & 15) {
    slot = g < 12 ? g / 3 : 3;
    k = (g < 12 ? g : g - 3) % 3;
  }
  __device__ bool writer() const { return g < 12 && k == 0 && slot < 3; }
  __device__ Fp2 from(const Fp2 &x, int s) const { return shfl(x, 3 * s + k, kWidth); }
  // product q of the slot's lanes
  __device__ Fp product(const Fp &t, int q) const { return shfl(t, 3 * slot + q, kWidth); }
  // Karatsuba with u^2 = -1: (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
  __device__ void mul(Fp2 &r, const Fp2 &a, const Fp2 &b) const {
    Fp x, y, t;
    add(x, a.c0, a.c1);
    add(y, b.c0, b.c1);
    fp_mul(t, sel(k == 0, a.c0, sel(k == 1, a.c1, x)), sel(k == 0, b.c0, sel(k == 1, b.c1, y)));
    x = product(t, 0);
    y = product(t, 1);
    sub(r.c0, x, y);
    add(x, x, y);
    sub(r.c1, product(t, 2), x);
  }
  // complex squaring: (a0 + a1)(a0 - a1) + 2 a0 a1 u (k = 2 repeats k = 1)
  __device__ void sqr(Fp2 &r, const Fp2 &a) const {
    Fp s, d, t;
    add(s, a.c0, a.c1);
    sub(d, a.c0, a.c1);
    fp_mul(t, sel(k == 0, s, a.c0), sel(k == 0, d, a.c1));
    r.c0 = product(t, 0);
    s = product(t, 1);
    add(r.c1, s, s);
  }
};

using G2Lanes = KaratsubaFp2;

// ------------------------------------------------------------ points ----
//
// A point in shared memory: L::kCoords coordinates (X, Y, Z, then G1's Z^2
// and Z^3), each kWords<F> 32-bit words.

template <class F>
constexpr int kWords = (int)(sizeof(F) / 4);

template <class L>
constexpr int kPointWords = L::kCoords * kWords<typename L::F>;

// `bits` holds a 4-bit field for each slot: slot j's
__device__ __forceinline__ int nibble(unsigned bits, int j) { return (bits >> (4 * j)) & 15; }

// Coordinate `slot` (0 X, 1 Y, 2 Z; slot 3 any) of dbl-2009-l of p, as
// jax_tier's pdouble: A = X1^2, B = Y1^2, C = B^2, D = 2((X1 + B)^2 - A - C),
// E = 3A, F = E^2, X3 = F - 2D, Y3 = E (D - X3) - 8C, Z3 = 2 Y1 Z1.
template <class L>
__device__ __forceinline__ typename L::F pair_double(const L &l, const uint32_t *p) {
  using F = typename L::F;
  constexpr int w = kWords<F>;
  const int j = l.slot;
  F a, b, m;
  // stage 1: A, B, Y1 Z1
  load(a, j == 0 ? p : p + w);
  load(b, j == 0 ? p : j == 1 ? p + w : p + 2 * w);
  l.mul(m, a, b);
  const F aa = l.from(m, 0), bb = l.from(m, 1);
  F z3 = l.from(m, 2), e;
  add(z3, z3, z3);
  add(e, aa, aa);
  add(e, e, aa);
  // stage 2, squarings on every slot: C, (X1 + B)^2, F
  load(a, p);
  add(a, a, bb);
  l.sqr(m, sel(j == 0, bb, sel(j == 1, a, e)));
  const F c = l.from(m, 0);
  F d = l.from(m, 1), x3 = l.from(m, 2);
  sub(d, d, aa);
  sub(d, d, c);
  add(d, d, d);
  add(a, d, d);
  sub(x3, x3, a);
  // stage 3: E (D - X3), the same on every slot
  sub(a, d, x3);
  l.mul(m, e, a);
  add(a, c, c);
  add(a, a, a);
  add(a, a, a);
  sub(m, m, a);
  return sel(j == 0, x3, sel(j == 1, m, z3));
}

// Coordinate `slot` (0 X, 1 Y, 2 Z, 3 Z^2, 4 Z^3; slots 5-7 any) of the G1
// double of p: dbl-2009-l as above, and Z3^2 = 4 B Z1^2, Z3^3 = 8 B (Y1 Z1^3),
// in three stages, a loop around one multiply
__device__ __forceinline__ Fp pair_double(const OctFp &l, const uint32_t *p) {
  constexpr int w = kLimbs;
  const int j = l.slot;
  Fp m, m1, m2, aa, c, d, e, x3;
#pragma unroll 1
  for (int stage = 1; stage <= 3; ++stage) {
    Fp a, b;
    if (stage == 1) {
      // A = X1 X1, B = Y1 Y1, Y1 Z1, Y1 Z1^3 (slots 0, 1, 2, 4; the others
      // repeat B)
      load(a, j == 0 ? p : p + w);
      load(b, p + nibble(0x11141210u, j) * w);
    } else if (stage == 2) {
      // C = B B, (X1 + B)^2, F = E E, B Z1^2, B Y1 Z1^3 (slots 0-4)
      m1 = m;
      aa = l.from(m1, 0);
      const Fp bb = l.from(m1, 1);
      add(e, aa, aa);
      add(e, e, aa);  // E = 3A
      load(a, p);
      add(a, a, bb);  // X1 + B
      load(b, p + 3 * w);
      a = sel(j == 1, a, sel(j == 2, e, bb));
      b = sel(j < 3, a, sel(j == 3, b, m1));
    } else {
      // E (D - X3) on every slot
      m2 = m;
      c = l.from(m2, 0);
      d = l.from(m2, 1);
      x3 = l.from(m2, 2);
      sub(d, d, aa);
      sub(d, d, c);
      add(d, d, d);
      add(a, d, d);
      sub(x3, x3, a);  // X3 = F - 2D
      sub(b, d, x3);
      a = e;
    }
    fp_mul(m, a, b);
  }
  // Y3 = E (D - X3) - 8C; Z3 = 2 Y1 Z1, Z3^2 = 4 B Z1^2, Z3^3 = 8 B Y1 Z1^3
  // from the slot's own products
  add(c, c, c);
  add(c, c, c);
  add(c, c, c);
  sub(m, m, c);
  add(m1, sel(j == 2, m1, m2), sel(j == 2, m1, m2));
  add(m2, m1, m1);
  add(e, m2, m2);
  return sel(j == 0, x3, sel(j == 1, m, sel(j == 2, m1, sel(j == 3, m2, e))));
}

// Coordinate `slot` of jax_tier's complete padd from coordinate `slot` of
// add-2007-bl's sum o: the all-zero point for P + (-P), the other point
// where one is the identity, the double where the same point comes twice
// (computed only where a live pair of the warp needs it; meanwhile the
// result waits in Q's coordinate, as Q is consumed, so that the double has
// the registers).
template <class L>
__device__ __forceinline__ typename L::F pair_select(const L &l, const uint32_t *p, uint32_t *q,
                                                     bool live, bool same_x, bool same_y,
                                                     typename L::F o) {
  using F = typename L::F;
  constexpr int w = kWords<F>;
  const int c = l.slot < L::kCoords ? l.slot : L::kCoords - 1;
  F a, b;
  load(a, p + 2 * w);
  load(b, q + 2 * w);
  const bool inf1 = is_zero(a), inf2 = is_zero(b);
  load(a, p + c * w);
  load(b, q + c * w);
  o = sel(inf1, b, sel(inf2, a, sel(same_x, F{}, o)));  // P + (-P): the all-zero point
  const bool twice = same_x && same_y && !inf1 && !inf2;
  if (__any_sync(kFull, live && twice)) {
    __syncwarp();  // every lane of the pair has read Q
    if (live && l.writer()) store(q + c * w, o);
    __syncwarp();
    const F d = pair_double(l, p);
    load(o, q + c * w);
    o = sel(twice, d, o);
  }
  return o;
}

// Coordinate `slot` of jax_tier's complete padd of the G2 points at p and
// q: add-2007-bl in five multiply stages on four slots (the header's G2
// table).  `live`: the pair's result is used.  The stages are a loop
// around one multiply, not unrolled, so that the code of a pair addition
// fits the instruction cache; a lane keeps the products of stages 2 and 3
// and the last one (each its slot's) and re-forms H, r, U1 and S1 from
// stage 2's products where used; stage 5 leaves X3 in m2 and 2 Z1Z2 H in
// m3.
template <class L>
__device__ __forceinline__ typename L::F pair_add(const L &l, const uint32_t *p, uint32_t *q,
                                                  bool live) {
  using F = typename L::F;
  constexpr int w = kWords<F>;
  const int j = l.slot;
  F m, m2, m3;  // the last stage's product, stage 2's and stage 3's
  bool same_x = false, same_y = false;
#pragma unroll 1
  for (int stage = 1; stage <= 5; ++stage) {
    F a, b;
    if (stage == 1) {  // Z1Z1, Z2Z2, Y1 Z2, Y2 Z1
      load(a, j == 0 ? p + 2 * w : j == 1 ? q + 2 * w : j == 2 ? p + w : q + w);
      load(b, (j == 0 || j == 3) ? p + 2 * w : q + 2 * w);
    } else if (stage == 2) {  // U1, U2, S1, S2: slots 0, 2 take Z2Z2, slots 1, 3 Z1Z1
      b = l.from(m, (j & 1) ^ 1);
      load(a, j == 0 ? p : q);
      a = sel(j < 2, a, m);
    } else if (stage == 3) {  // H^2, r^2, Z1 Z2
      F h, r;
      {
        const F x = l.from(m2, 0), y = l.from(m2, 1);  // U1, U2
        same_x = eq(x, y);
        sub(h, y, x);
      }
      {
        const F x = l.from(m2, 2), y = l.from(m2, 3);  // S1, S2
        same_y = eq(x, y);
        sub(r, y, x);
        add(r, r, r);
      }
      const F hr = sel(j == 0, h, r);
      load(a, p + 2 * w);
      load(b, q + 2 * w);
      a = sel(j == 2, a, hr);
      b = sel(j == 2, b, hr);
    } else if (stage == 4) {  // J = H I, V = U1 I, Z1Z2 H, where I = 4 H^2
      F i = l.from(m3, 0), h;
      add(i, i, i);
      add(i, i, i);
      const F u1 = l.from(m2, 0);
      sub(h, l.from(m2, 1), u1);
      const F z1z2 = l.from(m3, 2);
      a = sel(j == 0, h, sel(j == 1, u1, z1z2));
      b = sel(j == 2, h, i);
    } else {  // r (V - X3), S1 J, where X3 = r^2 - J - 2V; m is stage 4's
      const F s1 = l.from(m2, 2);
      F r = l.from(m2, 3);
      sub(r, r, s1);
      add(r, r, r);
      const F jj = l.from(m, 0);
      F t;
      a = sel(j == 1, s1, r);
      sub(m2, l.from(m3, 1), jj);  // X3 = r^2 - J ...
      t = l.from(m, 2);
      add(m3, t, t);  // Z3 = 2 Z1Z2 H
      {
        const F v = l.from(m, 1);
        add(t, v, v);
        sub(m2, m2, t);  // ... - 2V
        sub(t, v, m2);
      }
      b = sel(j == 1, jj, t);
    }
    l.mul(m, a, b);
    if (stage == 2) m2 = m;
    else if (stage == 3) m3 = m;
  }
  // Y3 = r (V - X3) - 2 S1 J
  F y3 = l.from(m, 0);
  {
    F t = l.from(m, 1);
    add(t, t, t);
    sub(y3, y3, t);
  }
  return pair_select(l, p, q, live, same_x, same_y, sel(j == 0, m2, sel(j == 1, y3, m3)));
}

// Coordinate `slot` of jax_tier's complete padd of the G1 points at p and
// q: add-2007-bl in three multiply stages on eight slots (the header's G1
// table), each slot one Fp multiply a stage.  The stages are a loop around
// one multiply, as G2's.
__device__ __forceinline__ Fp pair_add(const OctFp &l, const uint32_t *p, uint32_t *q, bool live) {
  constexpr int w = kLimbs;
  const int j = l.slot;
  Fp m, m1, m2;  // the last stage's product, stage 1's and stage 2's
  Fp h, r, k;
  bool same_x = false, same_y = false;
#pragma unroll 1
  for (int stage = 1; stage <= 3; ++stage) {
    Fp a, b;
    if (stage == 1) {
      // U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = Y1 Z2^3, S2 = Y2 Z1^3, B = Z1^2
      // Z2^2, C = Z1^3 Z2^3, A = Z1 Z2 (slots 6 and 7): slot j multiplies
      // coordinate nibble(.., j) of one point by one of the other
      const bool swap = (0xau >> j) & 1;  // slots 1 and 3 take Q's first
      load(a, (swap ? q : p) + nibble(0x22431100u, j) * w);
      load(b, (swap ? p : q) + nibble(0x22434433u, j) * w);
    } else if (stage == 2) {
      // H H, r r, S1 H, r (2 U1 + U2), B H, C H, A H, r r
      m1 = m;
      {
        const Fp u1 = l.from(m1, 0), u2 = l.from(m1, 1);
        same_x = eq(u1, u2);
        sub(h, u2, u1);
        add(k, u1, u2);  // U1 + U2 = H + 2 U1
        add(b, k, u1);   // 2 U1 + U2 = H + 3 U1
        const Fp s1 = l.from(m1, 2), s2 = l.from(m1, 3);
        same_y = eq(s1, s2);
        sub(r, s2, s1);
        add(r, r, r);
      }
      const bool rr = j == 1 || j == 7;
      a = sel(j == 0, h, sel(rr || j == 3, r, m1));
      b = sel(rr, r, sel(j == 3, b, h));
    } else {
      // H H (U1 + U2), y H H, B H H, C H H H, r r r (slots 0, 3, 4, 5, 7),
      // where y = r (2 U1 + U2) - 2 S1 H (slot 3)
      m2 = m;
      const Fp hh = l.from(m2, 0);
      Fp y = l.from(m2, 2);
      add(y, y, y);
      sub(y, m2, y);
      a = sel(j == 3, y, sel(j == 7, r, m2));
      b = sel(j == 0, k, sel(j == 4, h, sel(j == 7, m2, hh)));
    }
    fp_mul(m, a, b);
  }
  // X3 = r^2 - 4 H^2 (U1 + U2) = r^2 - J - 2V, Y3 = 4 y H^2 - r^3 =
  // r (V - X3) - 2 S1 J, Z3 = 2 A H, Z3^2 = 4 B H^2, Z3^3 = 8 C H^3: the
  // writer of coordinate j reads g from slot nibble(0x54630, j) (A H from
  // stage 2) and e from slot nibble(0x71, j) (r^2 from stage 2)
  {
    const Fp g = l.from(sel(j == 6, m2, m), nibble(0x54630u, j));
    const Fp e = l.from(sel(j == 1, m2, m), nibble(0x71u, j));
    add(m1, g, g);
    add(m2, m1, m1);
    add(h, m2, m2);
    sub(m, sel(j == 0, e, m2), sel(j == 0, m2, e));
  }
  return pair_select(l, p, q, live, same_x, same_y,
                     sel(j < 2, m, sel(j == 2, m1, sel(j == 3, m2, h))));
}

// The G1 points from the rows gain Z^2 and Z^3 beside X, Y, Z: a thread
// multiplies Z in twice for each of the `leaves` points (the other lane
// groups' points need nothing: fold_tiers calls this only where a point
// has more coordinates than a row)
__device__ __forceinline__ void complete(const OctFp &, uint32_t *pts, int leaves) {
  constexpr int w = kLimbs, W = kPointWords<OctFp>;
  for (int i = threadIdx.x; i < leaves; i += blockDim.x) {
    uint32_t *pt = pts + (size_t)i * W;
    Fp z, zk;
    load(z, pt + 2 * w);
    zk = z;
#pragma unroll 1
    for (int c = 3; c <= 4; ++c) {  // Z^2, then Z^3
      fp_mul(zk, zk, z);
      store(pt + c * w, zk);
    }
  }
}

// ------------------------------------------------------------- fold -----

extern __shared__ uint4 fold_smem[];

constexpr int kMaxTiers = 8;

// The fold's tiers (ops/bls12_381_fold.py plan()): a block of tier t folds
// leaves[t] points; tier 0's blocks fold the rows, tier t's the block sums
// of tier t - 1, and the last tier has one block.
struct Plan {
  int tiers;
  int leaves[kMaxTiers];
};

// The tree levels over the `leaves` points in shared memory: at stride s,
// pair t adds the points at 2 s t and 2 s t + s into the first; the sum
// ends in point 0.
template <class L>
__device__ __forceinline__ void fold_levels(uint32_t *pts, int leaves) {
  using F = typename L::F;
  constexpr int W = kPointWords<L>;
  const L l(threadIdx.x & 31);
  const int group = threadIdx.x / L::kWidth, groups = blockDim.x / L::kWidth;
  const int warp_first = (threadIdx.x & ~31) / L::kWidth;  // the warp's first group
  for (int s = 1; s < leaves; s *= 2) {
    const int pairs = leaves / (2 * s);
    for (int base = 0; base < pairs; base += groups) {
      const bool live = base + group < pairs;
      if (!__any_sync(kFull, live)) continue;  // the whole warp idles
      // a group past the last pair repeats its warp's first (live) one
      uint32_t *p = pts + (size_t)(base + (live ? group : warp_first)) * 2 * s * W;
      const F o = pair_add(l, p, p + s * W, live);
      __syncwarp();  // every lane of the pair has read p and q
      if (live && l.writer()) store(p + l.slot * kWords<F>, o);
    }
    __syncthreads();
  }
}

// The whole fold in one launch of plan.leaves[0]-point blocks.  A block
// folds its subtree of the rows (level 0 packs four 8-bit limbs a word and
// completes the points: complete()), writes its sum (all kCoords
// coordinates) to its tier's region of `scratch` and counts itself in its
// group's counter (after __threadfence(), so that the sum is visible); the
// block that completes a group of leaves[t + 1] folds the group's sums in
// tier t + 1, and so on; the last tier's block writes the sum to `out` as
// 8-bit limbs.  `counters` holds a zero for each group of every tier but
// the first, and zeros again when the fold ends: atomicInc wraps a group's
// counter to 0 at its last block.
template <class L>
__device__ __forceinline__ void fold_tiers(const int32_t *rows, uint32_t *scratch,
                                           unsigned *counters, int32_t *out, const Plan &plan) {
  using F = typename L::F;
  constexpr int R = 3 * kWords<F>, W = kPointWords<L>;  // words a row, a point
  uint32_t *pts = reinterpret_cast<uint32_t *>(fold_smem);
  __shared__ bool completes;
  int idx = blockIdx.x, blocks = gridDim.x;  // this block's subtree in its tier, the tier's
  const uint4 *in = nullptr;  // the tier's inputs: tier t - 1's block sums
  for (int t = 0;; ++t) {
    const int leaves = plan.leaves[t], n = leaves * W;
    // unrolled, so that a thread has several loads in flight
    if (t == 0) {
      const int4 *src = reinterpret_cast<const int4 *>(rows) + (size_t)idx * leaves * R;
#pragma unroll 8
      for (int k = threadIdx.x; k < leaves * R; k += blockDim.x) {
        const int4 l = src[k];
        pts[k / R * W + k % R] = (uint32_t)l.x | ((uint32_t)l.y << 8) |
                                 ((uint32_t)l.z << 16) | ((uint32_t)l.w << 24);
      }
      if constexpr (W != R) {
        __syncthreads();
        complete(L(threadIdx.x & 31), pts, leaves);
      }
    } else {  // other blocks wrote them in this launch: read through L2
      const uint4 *src = in + (size_t)idx * n / 4;  // W is a multiple of 4
#pragma unroll 4
      for (int k = threadIdx.x; k < n / 4; k += blockDim.x) fold_smem[k] = __ldcg(src + k);
    }
    __syncthreads();
    fold_levels<L>(pts, leaves);
    if (t == plan.tiers - 1) {
      for (int k = threadIdx.x; k < 4 * R; k += blockDim.x)  // X, Y, Z
        out[k] = (int32_t)((pts[k >> 2] >> (8 * (k & 3))) & 0xff);
      return;
    }
    uint32_t *sums = scratch + (size_t)idx * W;
    for (int k = threadIdx.x; k < W; k += blockDim.x) sums[k] = pts[k];
    __threadfence();
    __syncthreads();
    const int per = plan.leaves[t + 1];
    if (threadIdx.x == 0) completes = atomicInc(counters + idx / per, per - 1) == (unsigned)per - 1;
    __syncthreads();
    if (!completes) return;
    in = reinterpret_cast<const uint4 *>(scratch);
    scratch += (size_t)blocks * W;
    counters += blocks / per;
    idx /= per;
    blocks /= per;
  }
}

__global__ void __launch_bounds__(kG1Threads)
    fold_g1_kernel(const int32_t *rows, uint32_t *scratch, unsigned *counters, int32_t *out,
                   Plan plan) {
  fold_tiers<G1Lanes>(rows, scratch, counters, out, plan);
}

__global__ void __launch_bounds__(kG2Threads)
    fold_g2_kernel(const int32_t *rows, uint32_t *scratch, unsigned *counters, int32_t *out,
                   Plan plan) {
  fold_tiers<G2Lanes>(rows, scratch, counters, out, plan);
}

// The fold's one launch on `stream`, after a check of the plan: leaves[t]
// points a block in tier t, their product the bucket.
template <class K>
int launch_plan(K kernel, int threads, int words, const void *rows, void *scratch,
                void *counters, void *out, int bucket, const int *leaves, int tiers,
                void *stream) {
  if (tiers < 1 || tiers > kMaxTiers || ((uintptr_t)rows & 15) != 0 ||
      ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Plan plan{tiers, {}};
  long long n = bucket;
  for (int t = 0; t < tiers; ++t) {
    if (leaves[t] < 2 || leaves[t] > kMaxLeaves || (leaves[t] & (leaves[t] - 1)) != 0 ||
        n % leaves[t] != 0)
      return (int)cudaErrorInvalidValue;
    plan.leaves[t] = leaves[t];
    n /= leaves[t];
  }
  if (n != 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)leaves[0] * words * 4;  // tier 0 folds the most points
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<bucket / leaves[0], threads, smem, (cudaStream_t)stream>>>(
      (const int32_t *)rows, (uint32_t *)scratch, (unsigned *)counters, (int32_t *)out, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [bucket][3][48] int32 (16-byte aligned) -> out [3][48]; leaves[t]
// the points a block folds in tier t (ops/bls12_381_fold.py plan());
// scratch of 60 words (16-byte aligned) for each block of every tier but the
// last; counters: a zero for each block of every tier but the first, left
// zero by the fold
extern "C" int bls12_381_fold_g1_launch(const void *rows, void *scratch, void *counters,
                                        void *out, int bucket, const int *leaves, int tiers,
                                        void *stream) {
  return launch_plan(fold_g1_kernel, kG1Threads, kPointWords<G1Lanes>, rows, scratch, counters,
                     out, bucket, leaves, tiers, stream);
}

// rows [bucket][3][2][48] int32 -> out [3][2][48]; 72 words a block sum
extern "C" int bls12_381_fold_g2_launch(const void *rows, void *scratch, void *counters,
                                        void *out, int bucket, const int *leaves, int tiers,
                                        void *stream) {
  return launch_plan(fold_g2_kernel, kG2Threads, kPointWords<G2Lanes>, rows, scratch, counters,
                     out, bucket, leaves, tiers, stream);
}

// threads of a launch of `blocks` blocks of the G1 (1) or G2 (2) kernel
extern "C" int bls12_381_fold_threads(int group, int blocks) {
  return blocks * (group == 1 ? kG1Threads : kG2Threads);
}

// warps that one SM holds at once (occupancy calculator) of the G1 (1) or
// G2 (2) kernel at `leaves` points a block
extern "C" int bls12_381_fold_resident_warps(int group, int leaves) {
  int blocks = 0;
  const cudaError_t rc =
      group == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, fold_g1_kernel, kG1Threads,
                       (size_t)leaves * kPointWords<G1Lanes> * 4)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, fold_g2_kernel, kG2Threads,
                       (size_t)leaves * kPointWords<G2Lanes> * 4);
  return rc == cudaSuccess ? blocks * (group == 1 ? kG1Threads : kG2Threads) / 32 : -1;
}
