// GF(2^255-19) and twisted-Edwards point arithmetic for the Hopper kernels.
//
// Radix 2^51: five 64-bit limbs, products accumulated in 128 bits from
// native 64-bit multiplies (lo = a*b, hi = __umul64hi(a, b)).  This is the
// host C field of csrc/sha512_batch.c (fe_mul / fe_add / fe_sub / fe_carry /
// fe_tobytes) moved to the device.  The JAX package's 20 x 13-bit int32
// limbs were a TPU constraint (no native 64-bit multiply there); here they
// survive only at the kernel boundaries: inputs arrive as 13-bit limbs and
// are converted on load, outputs are written back as canonical 13-bit limbs.
//
// Limb bounds.  fe_mul takes limbs < 2^54 and returns limb 0 < 2^51 and the
// rest <= 2^51 + 2^13.  fe_add does not carry; fe_sub adds 2p, which is
// exact only while the subtrahend's limbs are < 2^52 - 38.  In every point
// formula below the subtrahend is a fe_mul output or a canonical value, and
// the largest fe_mul operand is an add of an add/sub result (< 2^53.5), so
// no extra carry is needed; 128-bit sums stay < 2^114 and every carry
// < 2^63.  fe_sq forms the same column sums from doubled (< 2^55) and
// 19-fold (< 2^59) operands, so it takes the same limbs.
//
// The point formulas are the JAX package's (ops/curve.py: add-2008-hwcd-3,
// madd-2008-hwcd-3, dbl-2008-hwcd for a = -1), term for term and in the same
// order, so projective coordinates agree with the plain torch version mod p
// even on points off the curve.
//
// Who uses what.  Kernel 1 (the ladder), pass A of kernel 2 (the doubling
// chain) and kernel 3 (the tabulated sum, two quads per signature) use the
// four-lane forms of ge_quad.cuh, which split each formula across a quad of
// lanes with the same products in the same order; they share fe_mul, fe_sq,
// fe_invert and finish_affine from here.  Pass B of kernel 2 (one thread
// per (validator, window) runs 14 adds of one point) uses the one-lane
// ge_to_cached and ge_add_cached.  The other one-lane point helpers
// (ge_double, ge_add, ge_madd: one thread carries a whole point) are the
// reference that the quad self-test (ed25519_ladder.cu) holds the quad
// forms against.
#pragma once

#include <stdint.h>

typedef unsigned long long u64;

#define MASK51 0x7ffffffffffffULL

struct fe {
  u64 v[5];
};

struct ge {
  fe X, Y, Z, T;
};

// 2d mod p in radix 2^51 (FE_D2 of csrc/sha512_batch.c)
static __constant__ u64 FE_TWO_D[5] = {0x69b9426b2f159ULL, 0x35050762add7aULL,
                                           0x3cf44c0038052ULL, 0x6738cc7407977ULL,
                                           0x2406d9dc56dffULL};

struct u128 {
  u64 lo, hi;
};

static __device__ __forceinline__ void mac(u128 &acc, u64 a, u64 b) {
  u64 lo = a * b;
  u64 hi = __umul64hi(a, b);
  acc.lo += lo;
  acc.hi += hi + (acc.lo < lo ? 1ULL : 0ULL);
}

static __device__ __forceinline__ void add64(u128 &acc, u64 c) {
  acc.lo += c;
  acc.hi += (acc.lo < c ? 1ULL : 0ULL);
}

static __device__ __forceinline__ u64 shr51(const u128 &t) { return (t.lo >> 51) | (t.hi << 13); }

static __device__ __forceinline__ void fe_zero(fe &r) {
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = 0;
}

static __device__ __forceinline__ void fe_add(fe &r, const fe &a, const fe &b) {
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
}

// r = a - b + 2p
static __device__ __forceinline__ void fe_sub(fe &r, const fe &a, const fe &b) {
  r.v[0] = a.v[0] + 0xfffffffffffdaULL - b.v[0];
#pragma unroll
  for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + 0xffffffffffffeULL - b.v[i];
}

static __device__ __forceinline__ void fe_carry(fe &t) {
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
  c = t.v[4] >> 51; t.v[4] &= MASK51; t.v[0] += 19 * c;
}

// carry the five 128-bit column sums of a product into limbs <= 2^51 + 2^13
static __device__ __forceinline__ void fe_reduce(fe &r, u128 t0, u128 t1, u128 t2, u128 t3,
                                                 u128 t4) {
  u64 c, r0, r1, r2, r3, r4;
  r0 = t0.lo & MASK51; c = shr51(t0);
  add64(t1, c); r1 = t1.lo & MASK51; c = shr51(t1);
  add64(t2, c); r2 = t2.lo & MASK51; c = shr51(t2);
  add64(t3, c); r3 = t3.lo & MASK51; c = shr51(t3);
  add64(t4, c); r4 = t4.lo & MASK51; c = shr51(t4);
  r0 += c * 19;
  c = r0 >> 51; r0 &= MASK51; r1 += c;
  r.v[0] = r0; r.v[1] = r1; r.v[2] = r2; r.v[3] = r3; r.v[4] = r4;
}

static __device__ __forceinline__ void fe_mul(fe &r, const fe &a, const fe &b) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  const u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19, b4_19 = b4 * 19;
  u128 t0 = {0, 0}, t1 = {0, 0}, t2 = {0, 0}, t3 = {0, 0}, t4 = {0, 0};
  mac(t0, a0, b0); mac(t0, a1, b4_19); mac(t0, a2, b3_19); mac(t0, a3, b2_19); mac(t0, a4, b1_19);
  mac(t1, a0, b1); mac(t1, a1, b0); mac(t1, a2, b4_19); mac(t1, a3, b3_19); mac(t1, a4, b2_19);
  mac(t2, a0, b2); mac(t2, a1, b1); mac(t2, a2, b0); mac(t2, a3, b4_19); mac(t2, a4, b3_19);
  mac(t3, a0, b3); mac(t3, a1, b2); mac(t3, a2, b1); mac(t3, a3, b0); mac(t3, a4, b4_19);
  mac(t4, a0, b4); mac(t4, a1, b3); mac(t4, a2, b2); mac(t4, a3, b1); mac(t4, a4, b0);
  fe_reduce(r, t0, t1, t2, t3, t4);
}

// a^2 in 15 products: the 128-bit column sums are fe_mul(a, a)'s exactly,
// so the result is bit-identical to it
static __device__ __forceinline__ void fe_sq(fe &r, const fe &a) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 d0 = 2 * a0, d1 = 2 * a1, d2 = 2 * a2, d3 = 2 * a3;
  const u64 a3_19 = a3 * 19, a4_19 = a4 * 19;
  u128 t0 = {0, 0}, t1 = {0, 0}, t2 = {0, 0}, t3 = {0, 0}, t4 = {0, 0};
  mac(t0, a0, a0); mac(t0, d1, a4_19); mac(t0, d2, a3_19);
  mac(t1, d0, a1); mac(t1, d2, a4_19); mac(t1, a3, a3_19);
  mac(t2, d0, a2); mac(t2, a1, a1); mac(t2, d3, a4_19);
  mac(t3, d0, a3); mac(t3, d1, a2); mac(t3, a4, a4_19);
  mac(t4, d0, a4); mac(t4, d1, a3); mac(t4, a2, a2);
  fe_reduce(r, t0, t1, t2, t3, t4);
}

static __device__ __noinline__ void fe_sqn(fe &r, const fe &a, int n) {
  r = a;
  for (int i = 0; i < n; i++) fe_sq(r, r);
}

// z^(p-2), the ref10 addition chain (254 squarings + 11 multiplies) that
// ops/curve.py invert uses
static __device__ __noinline__ void fe_invert(fe &out, const fe &z) {
  fe z2, z9, z11, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0, t;
  fe_sq(z2, z);
  fe_sqn(t, z2, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sq(t, z11);
  fe_mul(z_5_0, t, z9);
  fe_sqn(t, z_5_0, 5);
  fe_mul(z_10_0, t, z_5_0);
  fe_sqn(t, z_10_0, 10);
  fe_mul(z_20_0, t, z_10_0);
  fe_sqn(t, z_20_0, 20);
  fe_mul(t, t, z_20_0);  // 2^40 - 1
  fe_sqn(t, t, 10);
  fe_mul(z_50_0, t, z_10_0);
  fe_sqn(t, z_50_0, 50);
  fe_mul(z_100_0, t, z_50_0);
  fe_sqn(t, z_100_0, 100);
  fe_mul(t, t, z_100_0);  // 2^200 - 1
  fe_sqn(t, t, 50);
  fe_mul(t, t, z_50_0);  // 2^250 - 1
  fe_sqn(t, t, 5);
  fe_mul(out, t, z11);  // 2^255 - 21 = p - 2
}

// full reduction to [0, p) with every limb < 2^51 (fe_tobytes' reduction)
static __device__ __forceinline__ void fe_canon(fe &t) {
  fe_carry(t);
  fe_carry(t);
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
  t.v[4] &= MASK51;
}

// 20 non-negative 13-bit limbs (any int type, at most 15 bits each, from a
// pointer or anything else indexable) -> radix 2^51; bits at and above
// 2^255 fold back by 19
template <typename P>
static __device__ __forceinline__ void fe_from13(fe &r, P limbs) {
  fe_zero(r);
#pragma unroll
  for (int i = 0; i < 20; i++) {
    const u64 l = (u64)(uint32_t)limbs[i];
    const int bit = 13 * i, k = bit / 51, s = bit % 51;
    r.v[k] += (l << s) & MASK51;
    const u64 hi = l >> (51 - s);
    if (k + 1 < 5)
      r.v[k + 1] += hi;
    else
      r.v[0] += 19 * hi;
  }
  fe_carry(r);
}

// canonical radix-2^51 value -> the 13-bit limb at position i
static __device__ __forceinline__ int fe_limb13(const fe &c, int i) {
  const int bit = 13 * i, k = bit / 51, s = bit % 51;
  u64 v = c.v[k] >> s;
  if (s + 13 > 51 && k + 1 < 5) v |= c.v[k + 1] << (51 - s);
  return (int)(v & 0x1fff);
}

static __device__ __forceinline__ void fe_to13(int16_t *out, fe c) {
  fe_canon(c);
#pragma unroll
  for (int i = 0; i < 20; i++) out[i] = (int16_t)fe_limb13(c, i);
}

// a point stored as [4, 20] 13-bit limbs (X, Y, Z, T)
template <typename T>
static __device__ __forceinline__ void ge_from13(ge &r, const T *p) {
  fe_from13(r.X, p);
  fe_from13(r.Y, p + 20);
  fe_from13(r.Z, p + 40);
  fe_from13(r.T, p + 60);
}

// complete addition, add-2008-hwcd-3 (ops/curve.py point_add)
static __device__ __noinline__ void ge_add(ge &r, const ge &p, const ge &q) {
  fe a, b, c, d, e, f, g, h, t0, t1, two_d;
#pragma unroll
  for (int i = 0; i < 5; i++) two_d.v[i] = FE_TWO_D[i];
  fe_sub(t0, p.Y, p.X);
  fe_sub(t1, q.Y, q.X);
  fe_mul(a, t0, t1);
  fe_add(t0, p.Y, p.X);
  fe_add(t1, q.Y, q.X);
  fe_mul(b, t0, t1);
  fe_mul(c, p.T, two_d);
  fe_mul(c, c, q.T);
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// A point in the cached form (Y-X, Y+X, 2d*T, Z) that the complete add
// reads its second operand in: converting costs one multiply, and each add
// from it 8 instead of 9.
struct ge_cached {
  fe ymx, ypx, t2d, Z;
};

static __device__ __forceinline__ void ge_to_cached(ge_cached &r, const ge &p) {
  fe two_d;
#pragma unroll
  for (int i = 0; i < 5; i++) two_d.v[i] = FE_TWO_D[i];
  fe_sub(r.ymx, p.Y, p.X);
  fe_add(r.ypx, p.Y, p.X);
  fe_mul(r.t2d, p.T, two_d);
  r.Z = p.Z;
}

// add-2008-hwcd-3 with q cached: ge_add's formula with c = T1 * (2d*T2)
// instead of (T1*2d) * T2, equal mod p, not as limbs; the same products as
// ge_quad.cuh's quad_add.  Inlined into kernel 2 pass B's loop.
static __device__ __forceinline__ void ge_add_cached(ge &r, const ge &p, const ge_cached &q) {
  fe a, b, c, d, e, f, g, h, t0;
  fe_sub(t0, p.Y, p.X);
  fe_mul(a, t0, q.ymx);
  fe_add(t0, p.Y, p.X);
  fe_mul(b, t0, q.ypx);
  fe_mul(c, p.T, q.t2d);
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// mixed addition with (y-x, y+x, 2d*x*y), Z2 = 1 (ops/curve.py point_madd)
static __device__ __noinline__ void ge_madd(ge &r, const ge &p, const fe &ymx, const fe &ypx,
                                     const fe &td) {
  fe a, b, c, d, e, f, g, h, t0;
  fe_sub(t0, p.Y, p.X);
  fe_mul(a, t0, ymx);
  fe_add(t0, p.Y, p.X);
  fe_mul(b, t0, ypx);
  fe_mul(c, p.T, td);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// dbl-2008-hwcd (ops/curve.py point_double)
static __device__ __noinline__ void ge_double(ge &r, const ge &p) {
  fe a, b, c, e, f, g, h, t0;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);
  fe_add(h, a, b);
  fe_add(t0, p.X, p.Y);
  fe_sq(t0, t0);
  fe_sub(e, h, t0);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// 4-bit digit k (least significant first) of a 32-byte little-endian scalar
static __device__ __forceinline__ int scalar_digit(const uint8_t *le, int k) {
  return (le[k >> 1] >> (4 * (k & 1))) & 15;
}

// Compare canonical affine (x, y) limb for limb against the signature's raw
// R y limbs (never reduced, so a non-canonical R fails) and x parity, and
// write the verdict; optionally the 32-byte encoding of R'.
static __device__ __forceinline__ void finish_affine(const fe &x, const fe &y,
                                                     const int16_t *r_y, uint8_t r_sign,
                                                     uint8_t *ok, uint8_t *r_out) {
  bool good = (int)(x.v[0] & 1) == (int)r_sign;
#pragma unroll
  for (int i = 0; i < 20; i++) good = good && (fe_limb13(y, i) == (int)r_y[i]);
  *ok = good ? 1 : 0;
  if (r_out != nullptr) {
    const u64 w[4] = {y.v[0] | (y.v[1] << 51), (y.v[1] >> 13) | (y.v[2] << 38),
                      (y.v[2] >> 26) | (y.v[3] << 25), (y.v[3] >> 39) | (y.v[4] << 12)};
#pragma unroll
    for (int i = 0; i < 4; i++)
#pragma unroll
      for (int j = 0; j < 8; j++) r_out[8 * i + j] = (uint8_t)(w[i] >> (8 * j));
    r_out[31] |= (uint8_t)((x.v[0] & 1) << 7);
  }
}
