/* Batch SHA-512 for ed25519 host-side preparation.
 *
 * The TPU batch verifier's host prep hashes h = SHA-512(R || A || M) once
 * per signature (crypto/batch_verifier.py).  Python's hashlib is C-backed
 * but holds the GIL and pays per-call object overhead (~1.7 us/hash at
 * 10k-signature commit batches = 17 ms — level with the device kernel
 * time).  This translation unit hashes a whole batch in one call over a
 * contiguous buffer: ~4 ms for 10k messages.
 *
 * Reference contrast: the reference computes the same digest inside
 * golang.org/x/crypto/ed25519 one signature at a time
 * (crypto/ed25519/ed25519.go:151).
 *
 * Built on demand by crypto/hostprep.py (gcc -O3 -shared); no Python.h
 * dependency — plain C ABI via ctypes.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

#define ROTR(x, n) (((x) >> (n)) | ((x) << (64 - (n))))

static void sha512_block(uint64_t st[8], const uint8_t *p) {
  uint64_t w[80];
  for (int i = 0; i < 16; i++)
    w[i] = ((uint64_t)p[8 * i] << 56) | ((uint64_t)p[8 * i + 1] << 48) |
           ((uint64_t)p[8 * i + 2] << 40) | ((uint64_t)p[8 * i + 3] << 32) |
           ((uint64_t)p[8 * i + 4] << 24) | ((uint64_t)p[8 * i + 5] << 16) |
           ((uint64_t)p[8 * i + 6] << 8) | ((uint64_t)p[8 * i + 7]);
  for (int i = 16; i < 80; i++) {
    uint64_t s0 = ROTR(w[i - 15], 1) ^ ROTR(w[i - 15], 8) ^ (w[i - 15] >> 7);
    uint64_t s1 = ROTR(w[i - 2], 19) ^ ROTR(w[i - 2], 61) ^ (w[i - 2] >> 6);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
  for (int i = 0; i < 80; i++) {
    uint64_t S1 = ROTR(e, 14) ^ ROTR(e, 18) ^ ROTR(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = h + S1 + ch + K[i] + w[i];
    uint64_t S0 = ROTR(a, 28) ^ ROTR(a, 34) ^ ROTR(a, 39);
    uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + mj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

static void sha512_one(const uint8_t *msg, uint64_t len, uint8_t out[64]) {
  uint64_t st[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
                    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
                    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  uint64_t n = len;
  while (n >= 128) {
    sha512_block(st, msg);
    msg += 128;
    n -= 128;
  }
  uint8_t tail[256];
  memset(tail, 0, sizeof tail);
  memcpy(tail, msg, n);
  tail[n] = 0x80;
  size_t blocks = (n + 1 + 16 <= 128) ? 1 : 2;
  uint64_t bits = len * 8;
  uint8_t *lenp = tail + blocks * 128 - 8;
  for (int i = 0; i < 8; i++) lenp[i] = (uint8_t)(bits >> (56 - 8 * i));
  sha512_block(st, tail);
  if (blocks == 2) sha512_block(st, tail + 128);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(st[i] >> (56 - 8 * j));
}

/* Hash n concatenated messages: item i is buf[offs[i] .. offs[i+1]).
 * out receives n contiguous 64-byte digests. */
void sha512_batch(const uint8_t *buf, const uint64_t *offs, uint64_t n,
                  uint8_t *out) {
  for (uint64_t i = 0; i < n; i++)
    sha512_one(buf + offs[i], offs[i + 1] - offs[i], out + 64 * i);
}

/* ---- scalar reduction mod the ed25519 group order L ---------------------
 *
 * Barrett reduction (HAC 14.42, b = 2^64, k = 4) of the 512-bit digest to
 * h mod L.  Replaces a ~0.7 us/item Python bigint loop that cost ~7 ms on
 * a 10k-signature commit batch.  Constants below are
 *   L  = 2^252 + 27742317777372353535851937790883648493
 *   mu = floor(2^512 / L)
 * differential-tested against Python int arithmetic in tests/test_crypto.py.
 */

static const uint64_t L_LIMBS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                                    0x0ULL, 0x1000000000000000ULL};
static const uint64_t MU_LIMBS[5] = {0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL,
                                     0xffffffffffffffebULL, 0xffffffffffffffffULL,
                                     0xfULL};

/* r[0..9] = a[0..4] * b[0..4] (truncated at 10 limbs; exact here) */
static void mul5x5(const uint64_t *a, const uint64_t *b, uint64_t *r) {
  unsigned __int128 acc = 0;
  for (int k = 0; k < 10; k++) {
    uint64_t carry_hi = 0;
    for (int i = 0; i < 5; i++) {
      int j = k - i;
      if (j < 0 || j > 4) continue;
      unsigned __int128 prev = acc;
      acc += (unsigned __int128)a[i] * b[j];
      if (acc < prev) carry_hi++; /* 128-bit overflow into the next-next limb */
    }
    r[k] = (uint64_t)acc;
    acc = (acc >> 64) | ((unsigned __int128)carry_hi << 64);
  }
}

/* out32 = x (8 LE limbs) mod L, little-endian bytes */
static void mod_l(const uint64_t x[8], uint8_t out32[32]) {
  /* q1 = x / b^3: limbs x[3..7] */
  uint64_t q1[5];
  for (int i = 0; i < 5; i++) q1[i] = x[i + 3];
  /* q2 = q1 * mu (10 limbs); q3 = q2 / b^5 */
  uint64_t q2[10];
  mul5x5(q1, MU_LIMBS, q2);
  const uint64_t *q3 = q2 + 5;
  /* r2 = (q3 * L) mod b^5 */
  uint64_t lw[5] = {L_LIMBS[0], L_LIMBS[1], L_LIMBS[2], L_LIMBS[3], 0};
  uint64_t q3w[5] = {q3[0], q3[1], q3[2], q3[3], q3[4]};
  uint64_t prod[10];
  mul5x5(q3w, lw, prod);
  /* r = (x mod b^5) - r2, mod b^5 (borrow beyond limb 4 is discarded) */
  uint64_t r[5];
  unsigned __int128 borrow = 0;
  for (int i = 0; i < 5; i++) {
    unsigned __int128 d = (unsigned __int128)x[i] - prod[i] - borrow;
    r[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  /* at most two conditional subtractions of L */
  for (int iter = 0; iter < 3; iter++) {
    /* r >= L ? (r has 5 limbs; L has 4) */
    int ge = 1;
    if (r[4] == 0) {
      ge = 0;
      for (int i = 3; i >= 0; i--) {
        if (r[i] > L_LIMBS[i]) { ge = 1; break; }
        if (r[i] < L_LIMBS[i]) { ge = 0; break; }
        if (i == 0) ge = 1; /* equal */
      }
    }
    if (!ge) break;
    unsigned __int128 bw = 0;
    for (int i = 0; i < 5; i++) {
      uint64_t li = (i < 4) ? L_LIMBS[i] : 0;
      unsigned __int128 d = (unsigned __int128)r[i] - li - bw;
      r[i] = (uint64_t)d;
      bw = (d >> 64) ? 1 : 0;
    }
  }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) out32[8 * i + j] = (uint8_t)(r[i] >> (8 * j));
}

/* Hash n concatenated messages and reduce each digest mod L in one pass:
 * out receives n contiguous 32-byte little-endian scalars h mod L. */
void sha512_mod_l_batch(const uint8_t *buf, const uint64_t *offs, uint64_t n,
                        uint8_t *out) {
  for (uint64_t i = 0; i < n; i++) {
    uint8_t digest[64];
    sha512_one(buf + offs[i], offs[i + 1] - offs[i], digest);
    uint64_t x[8];
    for (int w = 0; w < 8; w++) {
      uint64_t v = 0;
      for (int j = 7; j >= 0; j--) v = (v << 8) | digest[8 * w + j];
      x[w] = v;
    }
    mod_l(x, out + 32 * i);
  }
}

/* ======================================================================= *
 * Incremental SHA-512 (for multi-segment hashing without host-side copies)
 * ======================================================================= */

typedef struct {
  uint64_t st[8];
  uint8_t buf[128];
  uint64_t buflen;
  uint64_t total;
} sha512_ctx;

static void sha512_init(sha512_ctx *c) {
  static const uint64_t IV[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
      0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  memcpy(c->st, IV, sizeof IV);
  c->buflen = 0;
  c->total = 0;
}

static void sha512_update(sha512_ctx *c, const uint8_t *p, uint64_t len) {
  c->total += len;
  if (c->buflen) {
    uint64_t take = 128 - c->buflen;
    if (take > len) take = len;
    memcpy(c->buf + c->buflen, p, take);
    c->buflen += take;
    p += take;
    len -= take;
    if (c->buflen == 128) {
      sha512_block(c->st, c->buf);
      c->buflen = 0;
    }
  }
  while (len >= 128) {
    sha512_block(c->st, p);
    p += 128;
    len -= 128;
  }
  if (len) {
    memcpy(c->buf, p, len);
    c->buflen = len;
  }
}

static void sha512_final(sha512_ctx *c, uint8_t out[64]) {
  uint8_t tail[256];
  uint64_t n = c->buflen;
  memset(tail, 0, sizeof tail);
  memcpy(tail, c->buf, n);
  tail[n] = 0x80;
  size_t blocks = (n + 1 + 16 <= 128) ? 1 : 2;
  uint64_t bits = c->total * 8;
  uint8_t *lenp = tail + blocks * 128 - 8;
  for (int i = 0; i < 8; i++) lenp[i] = (uint8_t)(bits >> (56 - 8 * i));
  sha512_block(c->st, tail);
  if (blocks == 2) sha512_block(c->st, tail + 128);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++)
      out[8 * i + j] = (uint8_t)(c->st[i] >> (56 - 8 * j));
}

/* ======================================================================= *
 * fe25519: GF(2^255-19) in radix 2^51 (5 uint64 limbs, donna-style)
 * ======================================================================= */

typedef uint64_t fe[5];

#define MASK51 0x7ffffffffffffULL

static const fe FE_D = {0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL, 0x739c663a03cbbULL, 0x52036cee2b6ffULL};
static const fe FE_D2 = {0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL, 0x6738cc7407977ULL, 0x2406d9dc56dffULL};
static const fe FE_BX = {0x62d608f25d51aULL, 0x412a4b4f6592aULL, 0x75b7171a4b31dULL, 0x1ff60527118feULL, 0x216936d3cd6e5ULL};
static const fe FE_BY = {0x6666666666658ULL, 0x4ccccccccccccULL, 0x1999999999999ULL, 0x3333333333333ULL, 0x6666666666666ULL};
static const fe FE_BT = {0x68ab3a5b7dda3ULL, 0xeea2a5eadbbULL, 0x2af8df483c27eULL, 0x332b375274732ULL, 0x67875f0fd78b7ULL};
static const fe FE_SQRTM1 = {0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL, 0x78595a6804c9eULL, 0x2b8324804fc1dULL};

static void fe_0(fe r) { r[0] = r[1] = r[2] = r[3] = r[4] = 0; }
static void fe_1(fe r) { r[0] = 1; r[1] = r[2] = r[3] = r[4] = 0; }
static void fe_copy(fe r, const fe a) { memcpy(r, a, sizeof(fe)); }

static void fe_add(fe r, const fe a, const fe b) {
  for (int i = 0; i < 5; i++) r[i] = a[i] + b[i];
}

/* r = a - b + 2p (valid for a,b with limbs < 2^52) */
static void fe_sub(fe r, const fe a, const fe b) {
  r[0] = a[0] + 0xfffffffffffdaULL - b[0];
  r[1] = a[1] + 0xffffffffffffeULL - b[1];
  r[2] = a[2] + 0xffffffffffffeULL - b[2];
  r[3] = a[3] + 0xffffffffffffeULL - b[3];
  r[4] = a[4] + 0xffffffffffffeULL - b[4];
}

static void fe_carry(fe t) {
  uint64_t c;
  c = t[0] >> 51; t[0] &= MASK51; t[1] += c;
  c = t[1] >> 51; t[1] &= MASK51; t[2] += c;
  c = t[2] >> 51; t[2] &= MASK51; t[3] += c;
  c = t[3] >> 51; t[3] &= MASK51; t[4] += c;
  c = t[4] >> 51; t[4] &= MASK51; t[0] += 19 * c;
}

static void fe_mul(fe r, const fe a, const fe b) {
  unsigned __int128 t0, t1, t2, t3, t4;
  uint64_t b1_19 = b[1] * 19, b2_19 = b[2] * 19, b3_19 = b[3] * 19,
           b4_19 = b[4] * 19;
  t0 = (unsigned __int128)a[0] * b[0] + (unsigned __int128)a[1] * b4_19 +
       (unsigned __int128)a[2] * b3_19 + (unsigned __int128)a[3] * b2_19 +
       (unsigned __int128)a[4] * b1_19;
  t1 = (unsigned __int128)a[0] * b[1] + (unsigned __int128)a[1] * b[0] +
       (unsigned __int128)a[2] * b4_19 + (unsigned __int128)a[3] * b3_19 +
       (unsigned __int128)a[4] * b2_19;
  t2 = (unsigned __int128)a[0] * b[2] + (unsigned __int128)a[1] * b[1] +
       (unsigned __int128)a[2] * b[0] + (unsigned __int128)a[3] * b4_19 +
       (unsigned __int128)a[4] * b3_19;
  t3 = (unsigned __int128)a[0] * b[3] + (unsigned __int128)a[1] * b[2] +
       (unsigned __int128)a[2] * b[1] + (unsigned __int128)a[3] * b[0] +
       (unsigned __int128)a[4] * b4_19;
  t4 = (unsigned __int128)a[0] * b[4] + (unsigned __int128)a[1] * b[3] +
       (unsigned __int128)a[2] * b[2] + (unsigned __int128)a[3] * b[1] +
       (unsigned __int128)a[4] * b[0];
  uint64_t c;
  r[0] = (uint64_t)t0 & MASK51; c = (uint64_t)(t0 >> 51);
  t1 += c; r[1] = (uint64_t)t1 & MASK51; c = (uint64_t)(t1 >> 51);
  t2 += c; r[2] = (uint64_t)t2 & MASK51; c = (uint64_t)(t2 >> 51);
  t3 += c; r[3] = (uint64_t)t3 & MASK51; c = (uint64_t)(t3 >> 51);
  t4 += c; r[4] = (uint64_t)t4 & MASK51; c = (uint64_t)(t4 >> 51);
  r[0] += c * 19;
  c = r[0] >> 51; r[0] &= MASK51; r[1] += c;
}

static void fe_sq(fe r, const fe a) { fe_mul(r, a, a); }

static void fe_frombytes(fe r, const uint8_t s[32]) {
  uint64_t w[4];
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | s[8 * i + j];
    w[i] = v;
  }
  r[0] = w[0] & MASK51;
  r[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
  r[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
  r[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
  r[4] = (w[3] >> 12) & MASK51; /* bit 255 dropped */
}

static void fe_tobytes(uint8_t s[32], const fe f) {
  uint64_t t[5];
  memcpy(t, f, sizeof t);
  fe_carry(t);
  fe_carry(t);
  /* q = 1 iff t >= p */
  uint64_t q = (t[0] + 19) >> 51;
  q = (t[1] + q) >> 51;
  q = (t[2] + q) >> 51;
  q = (t[3] + q) >> 51;
  q = (t[4] + q) >> 51;
  t[0] += 19 * q;
  uint64_t c;
  c = t[0] >> 51; t[0] &= MASK51; t[1] += c;
  c = t[1] >> 51; t[1] &= MASK51; t[2] += c;
  c = t[2] >> 51; t[2] &= MASK51; t[3] += c;
  c = t[3] >> 51; t[3] &= MASK51; t[4] += c;
  t[4] &= MASK51;
  uint64_t w0 = t[0] | (t[1] << 51);
  uint64_t w1 = (t[1] >> 13) | (t[2] << 38);
  uint64_t w2 = (t[2] >> 26) | (t[3] << 25);
  uint64_t w3 = (t[3] >> 39) | (t[4] << 12);
  uint64_t w[4] = {w0, w1, w2, w3};
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) s[8 * i + j] = (uint8_t)(w[i] >> (8 * j));
}

static int fe_isnonzero(const fe f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  uint8_t d = 0;
  for (int i = 0; i < 32; i++) d |= s[i];
  return d != 0;
}

static int fe_eq(const fe a, const fe b) {
  fe d;
  fe_sub(d, a, b);
  return !fe_isnonzero(d);
}

/* r = z^e, e given as 32 little-endian bytes (vartime, fine for verify) */
static void fe_pow(fe r, const fe z, const uint8_t e[32]) {
  fe result, base;
  fe_1(result);
  fe_copy(base, z);
  for (int i = 0; i < 255; i++) {
    if ((e[i >> 3] >> (i & 7)) & 1) fe_mul(result, result, base);
    fe_sq(base, base);
  }
  fe_copy(r, result);
}

static void fe_invert(fe r, const fe z) {
  /* p - 2 = 2^255 - 21 */
  static const uint8_t E[32] = {
      0xeb, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};
  fe_pow(r, z, E);
}

static void fe_pow2523(fe r, const fe z) {
  /* (p - 5) / 8 = 2^252 - 3 */
  static const uint8_t E[32] = {
      0xfd, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x0f};
  fe_pow(r, z, E);
}

/* ======================================================================= *
 * ge: point ops in extended coords (X, Y, Z, T), a = -1 twisted Edwards
 * ======================================================================= */

typedef struct {
  fe X, Y, Z, T;
} ge;

static void ge_identity(ge *r) {
  fe_0(r->X);
  fe_1(r->Y);
  fe_1(r->Z);
  fe_0(r->T);
}

static void ge_base(ge *r) {
  fe_copy(r->X, FE_BX);
  fe_copy(r->Y, FE_BY);
  fe_1(r->Z);
  fe_copy(r->T, FE_BT);
}

/* add-2008-hwcd-3 (complete for a=-1) */
static void ge_add(ge *r, const ge *p, const ge *q) {
  fe A, B, C, D, E, F, G, H, t0, t1;
  fe_sub(t0, p->Y, p->X);
  fe_sub(t1, q->Y, q->X);
  fe_mul(A, t0, t1);
  fe_add(t0, p->Y, p->X);
  fe_add(t1, q->Y, q->X);
  fe_mul(B, t0, t1);
  fe_mul(C, p->T, FE_D2);
  fe_mul(C, C, q->T);
  fe_mul(D, p->Z, q->Z);
  fe_add(D, D, D);
  fe_sub(E, B, A);
  fe_sub(F, D, C);
  fe_add(G, D, C);
  fe_add(H, B, A);
  fe_mul(r->X, E, F);
  fe_mul(r->Y, G, H);
  fe_mul(r->Z, F, G);
  fe_mul(r->T, E, H);
}

/* dbl-2008-hwcd */
static void ge_double(ge *r, const ge *p) {
  fe A, B, C, E, F, G, H, t0;
  fe_sq(A, p->X);
  fe_sq(B, p->Y);
  fe_sq(C, p->Z);
  fe_add(C, C, C);
  fe_add(H, A, B);
  fe_add(t0, p->X, p->Y);
  fe_sq(t0, t0);
  fe_sub(E, H, t0);
  fe_sub(G, A, B);
  fe_add(F, C, G);
  fe_mul(r->X, E, F);
  fe_mul(r->Y, G, H);
  fe_mul(r->Z, F, G);
  fe_mul(r->T, E, H);
}

static void ge_tobytes(uint8_t s[32], const ge *p) {
  fe zi, x, y;
  fe_invert(zi, p->Z);
  fe_mul(x, p->X, zi);
  fe_mul(y, p->Y, zi);
  fe_tobytes(s, y);
  uint8_t xb[32];
  fe_tobytes(xb, x);
  s[31] |= (xb[0] & 1) << 7;
}

/* little-endian compare against p; 1 iff y (bit 255 cleared) >= p */
static int ge_y_ge_p(const uint8_t s[32]) {
  static const uint8_t P_LE[32] = {
      0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};
  for (int i = 31; i >= 0; i--) {
    uint8_t b = (i == 31) ? (s[i] & 0x7f) : s[i];
    if (b > P_LE[i]) return 1;
    if (b < P_LE[i]) return 0;
  }
  return 1; /* equal */
}

/* decompress into (x, y); returns 0 on invalid encoding.  Matches
 * crypto/ed25519_math.decompress exactly (reject y>=p, x=0 with sign). */
static int ge_frombytes(ge *r, const uint8_t s[32]) {
  if (ge_y_ge_p(s)) return 0;
  int sign = s[31] >> 7;
  fe y, y2, u, v, v3, v7, x, chk, one;
  fe_frombytes(y, s);
  fe_1(one);
  fe_sq(y2, y);
  fe_sub(u, y2, one);          /* u = y^2 - 1 */
  fe_mul(v, y2, FE_D);
  fe_add(v, v, one);           /* v = d y^2 + 1 */
  fe_sq(v3, v);
  fe_mul(v3, v3, v);           /* v^3 */
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);           /* v^7 */
  fe_mul(x, u, v7);
  fe_pow2523(x, x);            /* (u v^7)^((p-5)/8) */
  fe_mul(x, x, v3);
  fe_mul(x, x, u);             /* x = u v^3 (u v^7)^((p-5)/8) */
  fe_sq(chk, x);
  fe_mul(chk, chk, v);         /* v x^2 */
  if (!fe_eq(chk, u)) {
    fe neg_u;
    fe_0(neg_u);
    fe_sub(neg_u, neg_u, u);
    if (!fe_eq(chk, neg_u)) return 0;
    fe_mul(x, x, FE_SQRTM1);
  }
  uint8_t xb[32];
  fe_tobytes(xb, x);
  int x_is_zero = 1;
  for (int i = 0; i < 32; i++)
    if (xb[i]) { x_is_zero = 0; break; }
  if (x_is_zero && sign) return 0;
  if ((xb[0] & 1) != sign) {
    fe_0(y2); /* reuse as scratch zero */
    fe_sub(x, y2, x);
  }
  fe_copy(r->X, x);
  fe_copy(r->Y, y);
  fe_1(r->Z);
  fe_mul(r->T, x, y);
  return 1;
}

static void ge_neg(ge *r, const ge *p) {
  fe zero;
  fe_0(zero);
  fe_sub(r->X, zero, p->X);
  fe_copy(r->Y, p->Y);
  fe_copy(r->Z, p->Z);
  fe_sub(r->T, zero, p->T);
}

/* r = [a]A + [b]B, scalars as 32 LE bytes (vartime Straus) */
static void ge_double_scalarmult(ge *r, const uint8_t a[32], const ge *A,
                                 const uint8_t b[32]) {
  ge pre[4]; /* index = 2*a_bit + b_bit */
  ge_identity(&pre[0]);
  ge_base(&pre[1]);
  pre[2] = *A;
  ge_add(&pre[3], A, &pre[1]);
  ge acc;
  ge_identity(&acc);
  for (int i = 255; i >= 0; i--) {
    ge_double(&acc, &acc);
    int sel = 2 * ((a[i >> 3] >> (i & 7)) & 1) + ((b[i >> 3] >> (i & 7)) & 1);
    if (sel) ge_add(&acc, &acc, &pre[sel]);
  }
  *r = acc;
}

/* r = [k]B, k as 32 LE bytes (vartime) */
static void ge_scalarmult_base(ge *r, const uint8_t k[32]) {
  ge acc, base;
  ge_identity(&acc);
  ge_base(&base);
  for (int i = 0; i < 256; i++) {
    if ((k[i >> 3] >> (i & 7)) & 1) ge_add(&acc, &acc, &base);
    ge_double(&base, &base);
  }
  *r = acc;
}

/* ======================================================================= *
 * scalar arithmetic mod L
 * ======================================================================= */

static const uint8_t L_LE[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7,
    0xa2, 0xde, 0xf9, 0xde, 0x14, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};

/* 1 iff s < L (canonical S) */
static int sc_minimal(const uint8_t s[32]) {
  for (int i = 31; i >= 0; i--) {
    if (s[i] > L_LE[i]) return 0;
    if (s[i] < L_LE[i]) return 1;
  }
  return 0; /* s == L */
}

static void load4x64(uint64_t w[4], const uint8_t s[32]) {
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | s[8 * i + j];
    w[i] = v;
  }
}

/* 64-byte LE digest -> h mod L (32 LE bytes) */
static void mod_l_bytes(const uint8_t digest[64], uint8_t out[32]) {
  uint64_t x[8];
  for (int w = 0; w < 8; w++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | digest[8 * w + j];
    x[w] = v;
  }
  mod_l(x, out);
}

/* out = (a*b + c) mod L, all 32 LE bytes */
static void sc_muladd(uint8_t out[32], const uint8_t a[32], const uint8_t b[32],
                      const uint8_t c[32]) {
  uint64_t A[4], B[4], C[4], r[8];
  load4x64(A, a);
  load4x64(B, b);
  load4x64(C, c);
  unsigned __int128 acc = 0;
  for (int k = 0; k < 8; k++) {
    uint64_t carry_hi = 0;
    for (int i = 0; i < 4; i++) {
      int j = k - i;
      if (j < 0 || j > 3) continue;
      unsigned __int128 prev = acc;
      acc += (unsigned __int128)A[i] * B[j];
      if (acc < prev) carry_hi++;
    }
    if (k < 4) {
      unsigned __int128 prev = acc;
      acc += C[k];
      if (acc < prev) carry_hi++;
    }
    r[k] = (uint64_t)acc;
    acc = (acc >> 64) | ((unsigned __int128)carry_hi << 64);
  }
  mod_l(r, out);
}

/* ======================================================================= *
 * ed25519 public API (serial host path; batch prep is further below)
 * ======================================================================= */

void ed25519_pubkey(const uint8_t seed[32], uint8_t out[32]) {
  uint8_t h[64];
  sha512_one(seed, 32, h);
  uint8_t a[32];
  memcpy(a, h, 32);
  a[0] &= 248;
  a[31] &= 63;
  a[31] |= 64;
  ge A;
  ge_scalarmult_base(&A, a);
  ge_tobytes(out, &A);
}

void ed25519_sign(const uint8_t seed[32], const uint8_t pub[32],
                  const uint8_t *msg, uint64_t len, uint8_t out[64]) {
  uint8_t h[64];
  sha512_one(seed, 32, h);
  uint8_t a[32];
  memcpy(a, h, 32);
  a[0] &= 248;
  a[31] &= 63;
  a[31] |= 64;
  sha512_ctx c;
  uint8_t dig[64], rb[32];
  sha512_init(&c);
  sha512_update(&c, h + 32, 32);
  sha512_update(&c, msg, len);
  sha512_final(&c, dig);
  mod_l_bytes(dig, rb); /* r = H(prefix || msg) mod L */
  ge R;
  ge_scalarmult_base(&R, rb);
  ge_tobytes(out, &R); /* out[0:32] = R */
  uint8_t k[32];
  sha512_init(&c);
  sha512_update(&c, out, 32);
  sha512_update(&c, pub, 32);
  sha512_update(&c, msg, len);
  sha512_final(&c, dig);
  mod_l_bytes(dig, k); /* k = H(R || A || msg) mod L */
  sc_muladd(out + 32, k, a, rb); /* s = k*a + r mod L */
}

/* Cofactorless verify with encoding compare — exact parity with
 * crypto/ed25519_math.verify (the x/crypto semantics the reference uses).
 * Returns 1 on success. */
int ed25519_verify(const uint8_t pub[32], const uint8_t *msg, uint64_t len,
                   const uint8_t sig[64]) {
  if (!sc_minimal(sig + 32)) return 0;
  ge A, negA, Rp;
  if (!ge_frombytes(&A, pub)) return 0;
  ge_neg(&negA, &A);
  sha512_ctx c;
  uint8_t dig[64], hb[32];
  sha512_init(&c);
  sha512_update(&c, sig, 32);
  sha512_update(&c, pub, 32);
  sha512_update(&c, msg, len);
  sha512_final(&c, dig);
  mod_l_bytes(dig, hb); /* h = H(R || A || M) mod L */
  ge_double_scalarmult(&Rp, hb, &negA, sig + 32); /* [h](-A) + [s]B */
  uint8_t rb[32];
  ge_tobytes(rb, &Rp);
  return memcmp(rb, sig, 32) == 0;
}

/* Serial batch: out[i] = verify(pks[32i], msgs[offs[i]:offs[i+1]], sigs[64i]) */
void ed25519_verify_batch(const uint8_t *pks, const uint8_t *msgs,
                          const uint64_t *offs, const uint8_t *sigs, uint64_t n,
                          uint8_t *out) {
  for (uint64_t i = 0; i < n; i++)
    out[i] = (uint8_t)ed25519_verify(pks + 32 * i, msgs + offs[i],
                                     offs[i + 1] - offs[i], sigs + 64 * i);
}

/* ======================================================================= *
 * ChaCha20-Poly1305 AEAD (RFC 8439) — SecretConnection frame crypto
 * ======================================================================= */

#define CHACHA_ROTL(v, n) (((v) << (n)) | ((v) >> (32 - (n))))
#define CHACHA_QR(a, b, c, d)                                   \
  do {                                                          \
    a += b; d ^= a; d = CHACHA_ROTL(d, 16);                     \
    c += d; b ^= c; b = CHACHA_ROTL(b, 12);                     \
    a += b; d ^= a; d = CHACHA_ROTL(d, 8);                      \
    c += d; b ^= c; b = CHACHA_ROTL(b, 7);                      \
  } while (0)

static uint32_t load32_le(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

static void store32_le(uint8_t *p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

static void chacha20_block(const uint8_t key[32], uint32_t counter,
                           const uint8_t nonce[12], uint8_t out[64]) {
  uint32_t st[16], w[16];
  st[0] = 0x61707865; st[1] = 0x3320646e; st[2] = 0x79622d32; st[3] = 0x6b206574;
  for (int i = 0; i < 8; i++) st[4 + i] = load32_le(key + 4 * i);
  st[12] = counter;
  for (int i = 0; i < 3; i++) st[13 + i] = load32_le(nonce + 4 * i);
  memcpy(w, st, sizeof st);
  for (int i = 0; i < 10; i++) {
    CHACHA_QR(w[0], w[4], w[8], w[12]);
    CHACHA_QR(w[1], w[5], w[9], w[13]);
    CHACHA_QR(w[2], w[6], w[10], w[14]);
    CHACHA_QR(w[3], w[7], w[11], w[15]);
    CHACHA_QR(w[0], w[5], w[10], w[15]);
    CHACHA_QR(w[1], w[6], w[11], w[12]);
    CHACHA_QR(w[2], w[7], w[8], w[13]);
    CHACHA_QR(w[3], w[4], w[9], w[14]);
  }
  for (int i = 0; i < 16; i++) store32_le(out + 4 * i, w[i] + st[i]);
}

static void chacha20_xor(const uint8_t key[32], uint32_t counter,
                         const uint8_t nonce[12], const uint8_t *in,
                         uint64_t len, uint8_t *out) {
  uint8_t block[64];
  for (uint64_t off = 0; off < len; off += 64) {
    chacha20_block(key, counter++, nonce, block);
    uint64_t take = len - off < 64 ? len - off : 64;
    for (uint64_t i = 0; i < take; i++) out[off + i] = in[off + i] ^ block[i];
  }
}

/* poly1305 (26-bit limb reference implementation) */
typedef struct {
  uint32_t r[5], h[5], pad[4];
  uint8_t buf[16];
  size_t buflen;
} poly1305_ctx;

static void poly1305_init(poly1305_ctx *c, const uint8_t key[32]) {
  c->r[0] = load32_le(key + 0) & 0x3ffffff;
  c->r[1] = (load32_le(key + 3) >> 2) & 0x3ffff03;
  c->r[2] = (load32_le(key + 6) >> 4) & 0x3ffc0ff;
  c->r[3] = (load32_le(key + 9) >> 6) & 0x3f03fff;
  c->r[4] = (load32_le(key + 12) >> 8) & 0x00fffff;
  for (int i = 0; i < 5; i++) c->h[i] = 0;
  for (int i = 0; i < 4; i++) c->pad[i] = load32_le(key + 16 + 4 * i);
  c->buflen = 0;
}

static void poly1305_blocks(poly1305_ctx *c, const uint8_t *m, size_t len,
                            uint32_t hibit) {
  uint32_t r0 = c->r[0], r1 = c->r[1], r2 = c->r[2], r3 = c->r[3], r4 = c->r[4];
  uint32_t s1 = r1 * 5, s2 = r2 * 5, s3 = r3 * 5, s4 = r4 * 5;
  uint32_t h0 = c->h[0], h1 = c->h[1], h2 = c->h[2], h3 = c->h[3], h4 = c->h[4];
  while (len >= 16) {
    h0 += load32_le(m + 0) & 0x3ffffff;
    h1 += (load32_le(m + 3) >> 2) & 0x3ffffff;
    h2 += (load32_le(m + 6) >> 4) & 0x3ffffff;
    h3 += (load32_le(m + 9) >> 6) & 0x3ffffff;
    h4 += (load32_le(m + 12) >> 8) | hibit;
    uint64_t d0 = (uint64_t)h0 * r0 + (uint64_t)h1 * s4 + (uint64_t)h2 * s3 +
                  (uint64_t)h3 * s2 + (uint64_t)h4 * s1;
    uint64_t d1 = (uint64_t)h0 * r1 + (uint64_t)h1 * r0 + (uint64_t)h2 * s4 +
                  (uint64_t)h3 * s3 + (uint64_t)h4 * s2;
    uint64_t d2 = (uint64_t)h0 * r2 + (uint64_t)h1 * r1 + (uint64_t)h2 * r0 +
                  (uint64_t)h3 * s4 + (uint64_t)h4 * s3;
    uint64_t d3 = (uint64_t)h0 * r3 + (uint64_t)h1 * r2 + (uint64_t)h2 * r1 +
                  (uint64_t)h3 * r0 + (uint64_t)h4 * s4;
    uint64_t d4 = (uint64_t)h0 * r4 + (uint64_t)h1 * r3 + (uint64_t)h2 * r2 +
                  (uint64_t)h3 * r1 + (uint64_t)h4 * r0;
    uint64_t cr;
    cr = d0 >> 26; h0 = (uint32_t)d0 & 0x3ffffff;
    d1 += cr; cr = d1 >> 26; h1 = (uint32_t)d1 & 0x3ffffff;
    d2 += cr; cr = d2 >> 26; h2 = (uint32_t)d2 & 0x3ffffff;
    d3 += cr; cr = d3 >> 26; h3 = (uint32_t)d3 & 0x3ffffff;
    d4 += cr; cr = d4 >> 26; h4 = (uint32_t)d4 & 0x3ffffff;
    h0 += (uint32_t)cr * 5;
    h1 += h0 >> 26;
    h0 &= 0x3ffffff;
    m += 16;
    len -= 16;
  }
  c->h[0] = h0; c->h[1] = h1; c->h[2] = h2; c->h[3] = h3; c->h[4] = h4;
}

static void poly1305_update(poly1305_ctx *c, const uint8_t *m, size_t len) {
  if (c->buflen) {
    size_t take = 16 - c->buflen;
    if (take > len) take = len;
    memcpy(c->buf + c->buflen, m, take);
    c->buflen += take;
    m += take;
    len -= take;
    if (c->buflen == 16) {
      poly1305_blocks(c, c->buf, 16, 1 << 24);
      c->buflen = 0;
    }
  }
  size_t full = len & ~(size_t)15;
  if (full) {
    poly1305_blocks(c, m, full, 1 << 24);
    m += full;
    len -= full;
  }
  if (len) {
    memcpy(c->buf, m, len);
    c->buflen = len;
  }
}

static void poly1305_final(poly1305_ctx *c, uint8_t tag[16]) {
  if (c->buflen) {
    c->buf[c->buflen] = 1;
    for (size_t i = c->buflen + 1; i < 16; i++) c->buf[i] = 0;
    poly1305_blocks(c, c->buf, 16, 0);
  }
  uint32_t h0 = c->h[0], h1 = c->h[1], h2 = c->h[2], h3 = c->h[3], h4 = c->h[4];
  uint32_t cr;
  cr = h1 >> 26; h1 &= 0x3ffffff; h2 += cr;
  cr = h2 >> 26; h2 &= 0x3ffffff; h3 += cr;
  cr = h3 >> 26; h3 &= 0x3ffffff; h4 += cr;
  cr = h4 >> 26; h4 &= 0x3ffffff; h0 += cr * 5;
  cr = h0 >> 26; h0 &= 0x3ffffff; h1 += cr;
  uint32_t g0, g1, g2, g3, g4;
  g0 = h0 + 5; cr = g0 >> 26; g0 &= 0x3ffffff;
  g1 = h1 + cr; cr = g1 >> 26; g1 &= 0x3ffffff;
  g2 = h2 + cr; cr = g2 >> 26; g2 &= 0x3ffffff;
  g3 = h3 + cr; cr = g3 >> 26; g3 &= 0x3ffffff;
  g4 = h4 + cr - (1 << 26);
  uint32_t mask = (g4 >> 31) - 1; /* all-ones iff h >= 2^130-5 */
  h0 = (h0 & ~mask) | (g0 & mask);
  h1 = (h1 & ~mask) | (g1 & mask);
  h2 = (h2 & ~mask) | (g2 & mask);
  h3 = (h3 & ~mask) | (g3 & mask);
  h4 = (h4 & ~mask) | (g4 & mask);
  uint64_t f;
  uint32_t o0 = h0 | (h1 << 26);
  uint32_t o1 = (h1 >> 6) | (h2 << 20);
  uint32_t o2 = (h2 >> 12) | (h3 << 14);
  uint32_t o3 = (h3 >> 18) | (h4 << 8);
  f = (uint64_t)o0 + c->pad[0]; store32_le(tag + 0, (uint32_t)f);
  f = (uint64_t)o1 + c->pad[1] + (f >> 32); store32_le(tag + 4, (uint32_t)f);
  f = (uint64_t)o2 + c->pad[2] + (f >> 32); store32_le(tag + 8, (uint32_t)f);
  f = (uint64_t)o3 + c->pad[3] + (f >> 32); store32_le(tag + 12, (uint32_t)f);
}

static void aead_tag(const uint8_t key[32], const uint8_t nonce[12],
                     const uint8_t *aad, uint64_t aadlen, const uint8_t *ct,
                     uint64_t ctlen, uint8_t tag[16]) {
  uint8_t block0[64];
  chacha20_block(key, 0, nonce, block0);
  poly1305_ctx c;
  poly1305_init(&c, block0);
  static const uint8_t zeros[16] = {0};
  poly1305_update(&c, aad, aadlen);
  if (aadlen & 15) poly1305_update(&c, zeros, 16 - (aadlen & 15));
  poly1305_update(&c, ct, ctlen);
  if (ctlen & 15) poly1305_update(&c, zeros, 16 - (ctlen & 15));
  uint8_t lens[16];
  for (int i = 0; i < 8; i++) {
    lens[i] = (uint8_t)(aadlen >> (8 * i));
    lens[8 + i] = (uint8_t)(ctlen >> (8 * i));
  }
  poly1305_update(&c, lens, 16);
  poly1305_final(&c, tag);
}

/* out = ciphertext || 16-byte tag */
void chacha20poly1305_seal(const uint8_t key[32], const uint8_t nonce[12],
                           const uint8_t *aad, uint64_t aadlen,
                           const uint8_t *pt, uint64_t ptlen, uint8_t *out) {
  chacha20_xor(key, 1, nonce, pt, ptlen, out);
  aead_tag(key, nonce, aad, aadlen, out, ptlen, out + ptlen);
}

/* returns 1 and fills out (sealedlen-16 bytes) on tag match, else 0 */
int chacha20poly1305_open(const uint8_t key[32], const uint8_t nonce[12],
                          const uint8_t *aad, uint64_t aadlen,
                          const uint8_t *sealed, uint64_t sealedlen,
                          uint8_t *out) {
  if (sealedlen < 16) return 0;
  uint64_t ctlen = sealedlen - 16;
  uint8_t tag[16];
  aead_tag(key, nonce, aad, aadlen, sealed, ctlen, tag);
  uint8_t diff = 0;
  for (int i = 0; i < 16; i++) diff |= tag[i] ^ sealed[ctlen + i];
  if (diff) return 0;
  chacha20_xor(key, 1, nonce, sealed, ctlen, out);
  return 1;
}

/* ======================================================================= *
 * One-pass batch host prep: bytes -> kernel-ready arrays
 *
 * Fuses, per signature, everything crypto/batch_verifier._scalar_rows used
 * to assemble from numpy pieces: SHA-512(R||A||M) + Barrett reduce mod L,
 * 4-bit MSB-first window digit extraction of h and s, 13-bit limb packing
 * of R's y coordinate, the R sign bit, and the canonical-S prefilter.
 * Memory-bound numpy passes (5+ intermediate [n, 64]/[n, 32] arrays)
 * collapse into one cache-resident loop, threaded across cores.
 * ======================================================================= */

#include <pthread.h>

/* [32 LE bytes] -> 64 4-bit digits, most-significant first (the kernel's
 * ladder order; parity with batch_verifier._msb_digits) */
static void msb_digits(const uint8_t le[32], uint8_t out[64]) {
  for (int k = 0; k < 32; k++) {
    out[63 - 2 * k] = le[k] & 15;
    out[62 - 2 * k] = le[k] >> 4;
  }
}

/* [32 LE bytes] -> 20 13-bit limbs of the low 255 bits (top limb 8 bits);
 * parity with hostprep.limbs_from_le_bytes */
static void limbs13(const uint8_t le[32], int16_t out[20]) {
  uint8_t padded[35];
  memcpy(padded, le, 32);
  padded[32] = padded[33] = padded[34] = 0;
  for (int i = 0; i < 20; i++) {
    int b = (13 * i) >> 3, sh = (13 * i) & 7;
    uint32_t v = (uint32_t)padded[b] | ((uint32_t)padded[b + 1] << 8) |
                 ((uint32_t)padded[b + 2] << 16);
    uint32_t limb = (v >> sh) & 0x1fff;
    if (i == 19) limb &= 0xff;
    out[i] = (int16_t)limb;
  }
}

typedef struct {
  const uint8_t *sigs;      /* n*64: R||S per item */
  const uint8_t *pks;       /* n*32 */
  const uint8_t *msgs;      /* concatenated messages */
  const uint64_t *offs;     /* n+1 */
  const uint8_t *skip;      /* n: 1 = item known-invalid, emit zeros */
  uint64_t start, end;
  uint8_t *h_digits;        /* n*64 */
  uint8_t *s_digits;        /* n*64 */
  int16_t *r_y;             /* n*20 */
  uint8_t *r_sign;          /* n */
  uint8_t *valid;           /* n */
} prep_job;

static void prep_range(prep_job *j) {
  sha512_ctx c;
  uint8_t dig[64], hb[32];
  for (uint64_t i = j->start; i < j->end; i++) {
    if (j->skip[i]) {
      memset(j->h_digits + 64 * i, 0, 64);
      memset(j->s_digits + 64 * i, 0, 64);
      memset(j->r_y + 20 * i, 0, 40);
      j->r_sign[i] = 0;
      j->valid[i] = 0;
      continue;
    }
    const uint8_t *sig = j->sigs + 64 * i;
    j->valid[i] = (uint8_t)sc_minimal(sig + 32);
    sha512_init(&c);
    sha512_update(&c, sig, 32);                     /* R */
    sha512_update(&c, j->pks + 32 * i, 32);         /* A */
    sha512_update(&c, j->msgs + j->offs[i], j->offs[i + 1] - j->offs[i]);
    sha512_final(&c, dig);
    mod_l_bytes(dig, hb);
    msb_digits(hb, j->h_digits + 64 * i);
    msb_digits(sig + 32, j->s_digits + 64 * i);
    limbs13(sig, j->r_y + 20 * i);
    j->r_sign[i] = sig[31] >> 7;
  }
}

static void *prep_worker(void *arg) {
  prep_range((prep_job *)arg);
  return NULL;
}

void ed25519_prep_batch(const uint8_t *sigs, const uint8_t *pks,
                        const uint8_t *msgs, const uint64_t *offs,
                        const uint8_t *skip, uint64_t n, uint8_t *h_digits,
                        uint8_t *s_digits, int16_t *r_y, uint8_t *r_sign,
                        uint8_t *valid, int nthreads) {
  prep_job base = {sigs, pks, msgs, offs, skip, 0, n,
                   h_digits, s_digits, r_y, r_sign, valid};
  if (nthreads <= 1 || n < 512) {
    prep_range(&base);
    return;
  }
  if (nthreads > 16) nthreads = 16;
  pthread_t threads[16];
  prep_job jobs[16];
  uint64_t chunk = (n + nthreads - 1) / nthreads;
  int spawned = 0;
  for (int t = 0; t < nthreads; t++) {
    uint64_t s = t * chunk, e = s + chunk;
    if (s >= n) break;
    if (e > n) e = n;
    jobs[t] = base;
    jobs[t].start = s;
    jobs[t].end = e;
    if (t + 1 < nthreads && e < n) {
      if (pthread_create(&threads[t], NULL, prep_worker, &jobs[t]) == 0) {
        spawned++;
        continue;
      }
    }
    prep_range(&jobs[t]); /* last slice (or create failure) runs inline */
  }
  for (int t = 0; t < spawned; t++) pthread_join(threads[t], NULL);
}
