// Twisted-Edwards point arithmetic on a quad: four lanes of a warp carry
// one point, lane j = (lane & 3) owning coordinate j of (X, Y, Z, T).
//
// The HWCD formulas of fe51.cuh are four-way parallel.  Each runs as two
// stages, and in each stage every lane does one field operation:
//
//   dbl-2008-hwcd      stage 1: X^2, Y^2, Z^2, (X+Y)^2      (squarings)
//   add-2008-hwcd-3    stage 1: a, b, c, d products
//   madd-2008-hwcd-3   stage 1: a, b, c (lane 3 carries Z1 through)
//   all three          stage 2: e*f, g*h, f*g, e*h -> X', Y', Z', T'
//
// Operands move within the quad by __shfl_sync (a field element is five
// 64-bit limbs: ten 32-bit shuffles), with the full mask: every lane of the
// warp takes part in every shuffle, so a caller never returns early before
// the last one.  Lanes differ by operand (selects), never by branch.  A
// point spread over several quads (kernel 3: two per signature) joins them
// by fe_shfl_xor across quads; table rows load one coordinate per lane
// (quad_row_fetch).
//
// Bit-identity with the one-lane helpers.  dbl and madd form the same
// products from the same operands in the same order as ge_double and
// ge_madd, so every output coordinate equals theirs bit for bit.  The add
// takes its second point in the cached form (Y-X, Y+X, 2d*T, Z): its c is
// T1 * (2d*T2) where ge_add forms (T1*2d) * T2, equal mod p but not as limbs,
// so its outputs equal ge_add's as field elements (canonical values), not as
// representatives.  chip_smoke.py holds both statements on the card.
//
// Limb bounds are those of fe51.cuh: every operand is the value the
// one-lane formula feeds to the same field operation (the cached Y-X and
// Y+X are the ge_add operands t1, precomputed; 2d*T is a multiply output).
#pragma once

#include "fe51.cuh"

static __device__ __forceinline__ fe fe_shfl(const fe &a, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = __shfl_sync(0xffffffffu, a.v[i], src, 4);
  return r;
}

static __device__ __forceinline__ fe fe_shfl_xor1(const fe &a) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], 1, 4);
  return r;
}

// the same coordinate from the quad `lane_mask` lanes away (4: the other
// quad of a pair), over the whole warp
static __device__ __forceinline__ fe fe_shfl_xor(const fe &a, int lane_mask) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], lane_mask);
  return r;
}

static __device__ __forceinline__ fe fe_sel(bool c, const fe &a, const fe &b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// coordinate j of the identity (0, 1, 1, 0)
static __device__ __forceinline__ fe quad_identity(int j) {
  fe r;
  fe_zero(r);
  r.v[0] = (j == 1 || j == 2) ? 1 : 0;
  return r;
}

// Coordinate j of a [4, 20] int16 table row, the 40 bytes at 40*j, read by
// lane j as five 8-byte loads: the quad reads the row's 160 contiguous
// bytes together.  Rows are 160 bytes apart in a 256-byte-aligned table, so
// each lane's words are 8-byte aligned (never 16: coordinate 1 starts at
// byte 40).  A caller converts it with fe_from13 (quad_row indexes as the
// 20 limbs), after it has fetched the next row.
struct quad_row {
  uint2 w[5];
  // limb n of the coordinate (four int16 limbs per word, little-endian)
  __device__ __forceinline__ uint32_t operator[](int n) const {
    const uint2 u = w[n >> 2];
    return (((n & 2) ? u.y : u.x) >> (16 * (n & 1))) & 0xffff;
  }
};

static __device__ __forceinline__ quad_row quad_row_fetch(const int16_t *row, int j) {
  const uint2 *src = reinterpret_cast<const uint2 *>(row + 20 * j);
  quad_row r;
#pragma unroll
  for (int k = 0; k < 5; k++) r.w[k] = __ldg(src + k);
  return r;
}

// coordinate j of a one-lane point
static __device__ __forceinline__ fe ge_coord(const ge &p, int j) {
  return fe_sel(j == 0, p.X, fe_sel(j == 1, p.Y, fe_sel(j == 2, p.Z, p.T)));
}

// Stage 2 of all three formulas: the stage-1 results a, b, c, zz (lanes 0-3)
// give e, f, g, h by add (d = 2*zz), and lane j multiplies its pair.
static __device__ __forceinline__ fe quad_out(const fe &e, const fe &f, const fe &g,
                                              const fe &h, int j) {
  const fe l = fe_sel(j == 0 || j == 3, e, fe_sel(j == 1, g, f));
  const fe r = fe_sel(j == 0, f, fe_sel(j == 2, g, h));
  fe out;
  fe_mul(out, l, r);
  return out;
}

static __device__ __forceinline__ fe quad_add_stage2(const fe &r, int j) {
  const fe a = fe_shfl(r, 0), b = fe_shfl(r, 1), c = fe_shfl(r, 2), zz = fe_shfl(r, 3);
  fe d, e, f, g, h;
  fe_add(d, zz, zz);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  return quad_out(e, f, g, h, j);
}

// Stage-1 left operand of add and madd, from the extended coordinate p:
// Y1-X1, Y1+X1, T1, Z1 on lanes 0-3 (lanes 0/1 and 2/3 swap theirs).
static __device__ __forceinline__ fe quad_add_left(const fe &p, int j) {
  const fe o = fe_shfl_xor1(p);
  fe ymx, ypx;
  fe_sub(ymx, o, p);  // lane 0: Y - X
  fe_add(ypx, p, o);  // lane 1: Y + X
  return fe_sel(j == 0, ymx, fe_sel(j == 1, ypx, o));
}

// dbl-2008-hwcd (ge_double)
static __device__ __forceinline__ fe quad_dbl(const fe &p, int j) {
  const fe x = fe_shfl(p, 0), y = fe_shfl(p, 1);
  fe xy, r;
  fe_add(xy, x, y);
  fe_sq(r, fe_sel(j == 3, xy, p));  // X^2, Y^2, Z^2, (X+Y)^2
  const fe a = fe_shfl(r, 0), b = fe_shfl(r, 1), zz = fe_shfl(r, 2), t0 = fe_shfl(r, 3);
  fe c, e, f, g, h;
  fe_add(c, zz, zz);
  fe_add(h, a, b);
  fe_sub(e, h, t0);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  return quad_out(e, f, g, h, j);
}

// coordinate j of the cached form (Y-X, Y+X, 2d*T, Z) of an extended point
static __device__ __forceinline__ fe quad_cached(const fe &p, int j) {
  const fe o = fe_shfl_xor1(p);  // lane 2 gets T, lane 3 gets Z
  fe two_d, td;
#pragma unroll
  for (int i = 0; i < 5; i++) two_d.v[i] = FE_TWO_D[i];
  fe_mul(td, o, two_d);
  return fe_sel(j == 2, td, quad_add_left(p, j) /* lanes 0, 1, 3 */);
}

// add-2008-hwcd-3 with q in cached form (quad_cached)
static __device__ __forceinline__ fe quad_add(const fe &p, const fe &q_cached, int j) {
  fe r;
  fe_mul(r, quad_add_left(p, j), q_cached);  // a, b, c, Z1*Z2
  return quad_add_stage2(r, j);
}

// madd-2008-hwcd-3 with q = (y-x, y+x, 2d*x*y); lane 3 passes any of the
// three as q and carries Z1 through stage 1 in place of a product
static __device__ __forceinline__ fe quad_madd(const fe &p, const fe &q, int j) {
  const fe l = quad_add_left(p, j);
  fe r;
  fe_mul(r, l, q);  // a, b, c; lane 3's product is discarded
  return quad_add_stage2(fe_sel(j == 3, l, r), j);
}

// Affine, canonical and compared (finish_affine).  Every lane runs the
// inversion of the same Z (the chain is serial, so spreading it would not
// shorten it, and a lane left idle costs the warp the same instruction slots);
// lanes 0 and 1 then form x and y in one step, and lane 0 writes when
// `live`.
static __device__ __forceinline__ void quad_finish(const fe &p, int j, bool live,
                                                   const int16_t *r_y, uint8_t r_sign,
                                                   uint8_t *ok, uint8_t *r_out) {
  const fe z = fe_shfl(p, 2);
  fe zinv, t;
  fe_invert(zinv, z);
  fe_mul(t, p, zinv);  // lane 0: x, lane 1: y
  fe_canon(t);
  const fe x = fe_shfl(t, 0), y = fe_shfl(t, 1);
  if (live && j == 0) finish_affine(x, y, r_y, r_sign, ok, r_out);
}
