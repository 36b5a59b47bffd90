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
// subtraction, as in JAX: the same-x and same-y tests compare limbs.
//
// The addition is jax_tier's _make_point_add: add-2007-bl and dbl-2009-l,
// small multiples by repeated addition, both computed, then per point
// Z1 = 0 gives Q, Z2 = 0 gives P, the same x and y the double, the same x
// alone the all-zero point.  The tree keeps _tree's association (at level s
// the point at i, i % 2^(s+1) == 0, becomes cur[i] + cur[i + 2^s], the
// lower index on the left; the result is row 0), so the Jacobian triple
// equals JAX's bit for bit.  Unlike JAX, which adds every lane of the bucket
// at every level, only the bucket / 2^(s+1) live pairs are computed.
//
// Design (simple first): one thread per live pair, one launch per level
// (log2(bucket) launches: 14 for the 16,384 bucket of 10,000 points) on the
// caller's stream.  Level 0 reads the int32 rows and packs four 8-bit limbs
// into a 32-bit word; every level writes its sums as 32-bit words into a
// scratch of bucket / 2 points (pair i at slot i / 2); the last level writes
// row 0 back as 8-bit limbs.  fp_mul and fp2_mul are __noinline__: the
// operands of a call live in the thread's stack, which keeps the G2 kernel's
// code small at the price of local-memory traffic (a G2 point is 72 words;
// two operands and the temporaries of an addition do not fit in 255
// registers anyway).
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
// This design computes both formulas for every pair (23 Fp multiplies for
// G1, 69 for G2, each squaring as a multiply); that, the 14 dependent
// levels, the tail levels' few threads (the last one adds on one thread)
// and the stack traffic keep it far above the bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLimbs = 12;
constexpr int kThreads = 128;

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

template <class F>
struct Point {
  F x, y, z;
};

// ---------------------------------------------------------------- Fp ----

// r = x mod P for x in [0, 2P) (12 limbs: 2P < 2^382)
__device__ __forceinline__ void fp_reduce(Fp &r, const uint32_t x[kLimbs]) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t s = (uint64_t)x[j] - kP[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = borrow ? x[j] : d[j];  // no borrow: x >= P
}

// r = a * b * R^-1 mod P, CIOS
__device__ __noinline__ void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  uint32_t t[kLimbs + 2];
#pragma unroll
  for (int j = 0; j < kLimbs + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t bi = b.v[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      c += (uint64_t)a.v[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kLimbs];
    t[kLimbs] = (uint32_t)c;
    t[kLimbs + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kN0;
    c = ((uint64_t)m * kP[0] + t[0]) >> 32;  // the low word is 0 by the choice of m
#pragma unroll
    for (int j = 1; j < kLimbs; ++j) {
      c += (uint64_t)m * kP[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kLimbs];
    t[kLimbs - 1] = (uint32_t)c;
    t[kLimbs] = t[kLimbs + 1] + (uint32_t)(c >> 32);
  }
  fp_reduce(r, t);  // t < 2P: t[12] is 0
}

__device__ __forceinline__ void fp_add(Fp &r, const Fp &a, const Fp &b) {
  uint32_t s[kLimbs];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    c += (uint64_t)a.v[j] + b.v[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce(r, s);  // a + b < 2P < 2^382: no carry out
}

__device__ __forceinline__ void fp_sub(Fp &r, const Fp &a, const Fp &b) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t s = (uint64_t)a.v[j] - b.v[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // a - b < 0: add P back (mod 2^384), which lands in (0, P)
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    c += (uint64_t)d[j] + (kP[j] & mask);
    r.v[j] = (uint32_t)c;
    c >>= 32;
  }
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

__device__ __forceinline__ void mul(Fp &r, const Fp &a, const Fp &b) { fp_mul(r, a, b); }
__device__ __forceinline__ void add(Fp &r, const Fp &a, const Fp &b) { fp_add(r, a, b); }
__device__ __forceinline__ void sub(Fp &r, const Fp &a, const Fp &b) { fp_sub(r, a, b); }

// --------------------------------------------------------------- Fp2 ----

// Karatsuba with u^2 = -1: (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u
__device__ __noinline__ void fp2_mul(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  Fp t0, t1, t2, sa, sb;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(sa, a.c0, a.c1);
  fp_add(sb, b.c0, b.c1);
  fp_mul(t2, sa, sb);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}

__device__ __forceinline__ void mul(Fp2 &r, const Fp2 &a, const Fp2 &b) { fp2_mul(r, a, b); }

__device__ __forceinline__ void add(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void sub(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ bool is_zero(const Fp2 &a) { return is_zero(a.c0) && is_zero(a.c1); }

__device__ __forceinline__ bool eq(const Fp2 &a, const Fp2 &b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}

// ------------------------------------------------------------ points ----

// r = k * a by k - 1 additions, as jax_tier's fmuls (k in 2, 3, 4, 8)
template <class F>
__device__ __forceinline__ void muls(F &r, const F &a, int k) {
  F out = a;
  for (int i = 1; i < k; ++i) add(out, out, a);
  r = out;
}

// dbl-2009-l, as jax_tier's pdouble
template <class F>
__device__ void point_double(Point<F> &r, const Point<F> &p) {
  F a, b, c, d, e, t, u;
  mul(a, p.x, p.x);
  mul(b, p.y, p.y);
  mul(c, b, b);
  add(t, p.x, b);
  mul(t, t, t);
  sub(t, t, a);
  sub(t, t, c);
  muls(d, t, 2);
  muls(e, a, 3);
  mul(t, e, e);  // f
  muls(u, d, 2);
  sub(r.x, t, u);
  sub(t, d, r.x);
  mul(t, e, t);
  muls(u, c, 8);
  sub(r.y, t, u);
  mul(t, p.y, p.z);
  muls(r.z, t, 2);
}

// jax_tier's complete padd: add-2007-bl and the double, selected per point
template <class F>
__device__ void point_add(Point<F> &r, const Point<F> &p, const Point<F> &q) {
  F z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t, w;
  Point<F> s;
  mul(z1z1, p.z, p.z);
  mul(z2z2, q.z, q.z);
  mul(u1, p.x, z2z2);
  mul(u2, q.x, z1z1);
  mul(t, p.y, q.z);
  mul(s1, t, z2z2);
  mul(t, q.y, p.z);
  mul(s2, t, z1z1);
  sub(h, u2, u1);
  mul(t, h, h);
  muls(i, t, 4);
  mul(j, h, i);
  sub(t, s2, s1);
  muls(rr, t, 2);
  mul(v, u1, i);
  mul(t, rr, rr);
  sub(t, t, j);
  muls(w, v, 2);
  sub(s.x, t, w);
  sub(t, v, s.x);
  mul(t, rr, t);
  mul(w, s1, j);
  muls(w, w, 2);
  sub(s.y, t, w);
  mul(t, p.z, q.z);
  mul(t, t, h);
  muls(s.z, t, 2);

  Point<F> d;
  point_double(d, p);

  const bool inf1 = is_zero(p.z), inf2 = is_zero(q.z);
  const bool same_x = eq(u1, u2), same_y = eq(s1, s2);
  if (inf1) {
    r = q;
  } else if (inf2) {
    r = p;
  } else if (same_x && same_y) {
    r = d;
  } else if (same_x) {
    r = Point<F>{};  // P + (-P): the all-zero point
  } else {
    r = s;
  }
}

// ------------------------------------------------------------- rows ----

// a point from JAX rows (8-bit limbs in int32)
template <class F>
__device__ __forceinline__ void load_rows(Point<F> &p, const int32_t *src) {
  uint32_t *w = reinterpret_cast<uint32_t *>(&p);
  constexpr int n = 3 * (int)(sizeof(F) / 4);
  for (int k = 0; k < n; ++k) {
    const int32_t *l = src + 4 * k;
    w[k] = (uint32_t)l[0] | ((uint32_t)l[1] << 8) | ((uint32_t)l[2] << 16) |
           ((uint32_t)l[3] << 24);
  }
}

template <class F>
__device__ __forceinline__ void store_rows(int32_t *dst, const Point<F> &p) {
  const uint32_t *w = reinterpret_cast<const uint32_t *>(&p);
  constexpr int n = 3 * (int)(sizeof(F) / 4);
  for (int k = 0; k < n; ++k) {
    dst[4 * k] = (int32_t)(w[k] & 0xff);
    dst[4 * k + 1] = (int32_t)((w[k] >> 8) & 0xff);
    dst[4 * k + 2] = (int32_t)((w[k] >> 16) & 0xff);
    dst[4 * k + 3] = (int32_t)(w[k] >> 24);
  }
}

template <class F>
__device__ __forceinline__ void load_words(Point<F> &p, const uint32_t *src) {
  uint32_t *w = reinterpret_cast<uint32_t *>(&p);
  constexpr int n = 3 * (int)(sizeof(F) / 4);
  for (int k = 0; k < n; ++k) w[k] = src[k];
}

template <class F>
__device__ __forceinline__ void store_words(uint32_t *dst, const Point<F> &p) {
  const uint32_t *w = reinterpret_cast<const uint32_t *>(&p);
  constexpr int n = 3 * (int)(sizeof(F) / 4);
  for (int k = 0; k < n; ++k) dst[k] = w[k];
}

// One tree level: pair t adds the points at i = t * 2^(level+1) and
// i + 2^level.  Level 0 reads `rows` (non-null only there); the last level
// writes `out` (non-null only there), every other the scratch slot i / 2.
template <class F>
__device__ void fold_level(const int32_t *rows, uint32_t *cur, int32_t *out, int level,
                           int pairs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  constexpr int words = 3 * (int)(sizeof(F) / 4);  // per point
  const size_t i = (size_t)t << (level + 1), j = i + ((size_t)1 << level);
  Point<F> p, q, r;
  if (rows != nullptr) {
    load_rows(p, rows + 4 * words * i);
    load_rows(q, rows + 4 * words * j);
  } else {
    load_words(p, cur + words * (i >> 1));
    load_words(q, cur + words * (j >> 1));
  }
  point_add(r, p, q);
  if (out != nullptr)
    store_rows(out, r);
  else
    store_words(cur + words * (i >> 1), r);
}

__global__ void fold_g1_kernel(const int32_t *rows, uint32_t *cur, int32_t *out, int level,
                               int pairs) {
  fold_level<Fp>(rows, cur, out, level, pairs);
}

__global__ void fold_g2_kernel(const int32_t *rows, uint32_t *cur, int32_t *out, int level,
                               int pairs) {
  fold_level<Fp2>(rows, cur, out, level, pairs);
}

int levels(int bucket) {
  int s = 0;
  while ((1 << s) < bucket) ++s;
  return s;
}

template <class K>
int launch_levels(K kernel, const void *rows, void *scratch, void *out, int bucket,
                  void *stream) {
  if (bucket < 2 || (bucket & (bucket - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int steps = levels(bucket);
  for (int level = 0; level < steps; ++level) {
    const int pairs = bucket >> (level + 1);
    const int blocks = (pairs + kThreads - 1) / kThreads;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        level == 0 ? (const int32_t *)rows : nullptr, (uint32_t *)scratch,
        level == steps - 1 ? (int32_t *)out : nullptr, level, pairs);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

}  // namespace

// rows [bucket][3][48] int32 -> out [3][48]; scratch of bucket / 2 points
// (36 32-bit words each); bucket a power of two >= 2
extern "C" int bls12_381_fold_g1_launch(const void *rows, void *scratch, void *out, int bucket,
                                        void *stream) {
  return launch_levels(fold_g1_kernel, rows, scratch, out, bucket, stream);
}

// rows [bucket][3][2][48] int32 -> out [3][2][48]; scratch of bucket / 2
// points (72 words each)
extern "C" int bls12_381_fold_g2_launch(const void *rows, void *scratch, void *out, int bucket,
                                        void *stream) {
  return launch_levels(fold_g2_kernel, rows, scratch, out, bucket, stream);
}

// threads of a fold's widest launch (level 0) for a bucket
extern "C" int bls12_381_fold_threads(int bucket) {
  return (bucket / 2 + kThreads - 1) / kThreads * kThreads;
}

// warps that one SM holds at once (occupancy calculator) of the G1 (1) or
// G2 (2) kernel
extern "C" int bls12_381_fold_resident_warps(int group) {
  int blocks = 0;
  const cudaError_t rc =
      group == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fold_g1_kernel, kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fold_g2_kernel, kThreads, 0);
  return rc == cudaSuccess ? blocks * kThreads / 32 : -1;
}
