// Montgomery arithmetic over Fr (BLS12-381 scalar field, 8 x 32-bit words,
// R = 2^256) and Fq (base field, 12 x 32-bit words, R = 2^384).
//
// The Python side stores a field element as L 16-bit limbs in int32 planes
// ((..., L, N) layout, limb-major, element axis minormost), exactly the
// values of the JAX package's uint32 limb arrays.  Kernels pair the 16-bit
// limbs into 32-bit words on load and split them on store.  R is the same
// (2^256 / 2^384), so every Montgomery value is bit-identical to the JAX
// package's, and every result here is canonical (< p), as
// LimbField._mul_xla returns it.
//
// Hopper has the native 32x32->64 multiply the TPU lacks, so the 16-bit
// lazy-carry schedule of the JAX kernels becomes word arithmetic: for Fr a
// plain CIOS loop over 32-bit words with 64-bit accumulators; for Fq (the
// EC kernels' field) carry-flag chains in PTX (ptx.cuh), below.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

static __constant__ uint32_t FR_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static constexpr uint32_t FR_N0 = 0xffffffffu;  // -p^-1 mod 2^32

static constexpr uint32_t FQ_N0 = 0xfffcfffdu;

// Fq's modulus and Montgomery 1 (R mod q, the Y of the projective identity
// (0, 1, 0)) as immediates: every caller indexes them with a constant
// after unrolling, so each word folds into the instruction that uses it.
#define FQ_P_WORDS                                                   \
  {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,  \
   0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,  \
   0x397fe69au, 0x1a0111eau}
#define FQ_ONE_WORDS                                                 \
  {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,  \
   0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,  \
   0xfa80e493u, 0x15f65ec3u}

template <int NW>
struct FieldTraits;

template <>
struct FieldTraits<8> {
  static __device__ __forceinline__ uint32_t p(int i) { return FR_P[i]; }
  static constexpr uint32_t n0 = FR_N0;
};

// -- limb planes <-> words -----------------------------------------------------

// Read one element: limb l of the element sits at src[l * stride].
template <int NW>
__device__ __forceinline__ void load_limbs(uint32_t (&w)[NW],
                                           const uint32_t* src,
                                           int64_t stride) {
#pragma unroll
  for (int i = 0; i < NW; i++) {
    w[i] = (src[(2 * i) * stride] & 0xffffu) |
           (src[(2 * i + 1) * stride] << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_limbs(uint32_t* dst, int64_t stride,
                                            const uint32_t (&w)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; i++) {
    dst[(2 * i) * stride] = w[i] & 0xffffu;
    dst[(2 * i + 1) * stride] = w[i] >> 16;
  }
}

// -- modular add / sub -----------------------------------------------------------

// r = a - p if a >= p else a  (one conditional subtraction, as
// LimbField._cond_sub_mod); `hi` is a carry word above the top word.
template <int NW>
__device__ __forceinline__ void cond_sub_p(uint32_t (&r)[NW],
                                           const uint32_t (&a)[NW],
                                           uint32_t hi) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t t = (uint64_t)a[i] - FieldTraits<NW>::p(i) - borrow;
    d[i] = (uint32_t)t;
    borrow = (t >> 32) & 1u;
  }
  // a >= p iff the subtraction did not borrow past the carry word
  bool ge = hi != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < NW; i++) r[i] = ge ? d[i] : a[i];
}

template <int NW>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW]) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    c += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_p<NW>(r, s, (uint32_t)c);
}

template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW]) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (t >> 32) & 1u;
  }
  // on borrow add p back (mod 2^(32 NW)), as LimbField.sub
  uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    c += (uint64_t)d[i] + (FieldTraits<NW>::p(i) & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

// -- Montgomery multiply (CIOS) ---------------------------------------------------

// r = a * b * 2^(-32 NW) mod p, canonical.  The word-serial reduction
// builds the same m = -ab/p mod R as the JAX package's separated form, so
// (ab + mp) / R and its one conditional subtraction agree bit for bit.
template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NW],
                                         const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW]) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);

    uint32_t m = t[0] * FieldTraits<NW>::n0;
    c = (uint64_t)m * FieldTraits<NW>::p(0) + t[0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < NW; j++) {
      c += (uint64_t)m * FieldTraits<NW>::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  uint32_t lo[NW];
#pragma unroll
  for (int i = 0; i < NW; i++) lo[i] = t[i];
  cond_sub_p<NW>(r, lo, t[NW]);
}

// -- Fq on carry-flag chains ----------------------------------------------------------
//
// The generic forms above carry through 64-bit adds and shifts: every word
// step waits for the one before it, ~290 dependent steps an Fq multiply.
// Here each word step is one PTX instruction on the carry flag, the
// modulus words are immediates, and the multiply keeps the products of
// a's even and odd words in two accumulators (even: word pairs at
// positions 0..11; odd: one word up), so two independent carry chains
// run side by side.  The results are the same canonical values: a Montgomery
// product a b R^-1 mod q in [0, q) is unique, and R is still 2^384.
// Every input must be canonical (< q), as every value of the EC kernels is.

template <>
__device__ __forceinline__ void cond_sub_p<12>(uint32_t (&r)[12],
                                               const uint32_t (&a)[12],
                                               uint32_t hi) {
  const uint32_t q[12] = FQ_P_WORDS;
  uint32_t d[12];
  d[0] = sub_cc(a[0], q[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) d[i] = subc_cc(a[i], q[i]);
  // hi:a - q borrows iff hi:a < q; then the top word is all ones
  bool ge = subc(hi, 0) != 0xffffffffu;
#pragma unroll
  for (int i = 0; i < 12; i++) r[i] = ge ? d[i] : a[i];
}

template <>
__device__ __forceinline__ void add_mod<12>(uint32_t (&r)[12],
                                            const uint32_t (&a)[12],
                                            const uint32_t (&b)[12]) {
  uint32_t s[12];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) s[i] = addc_cc(a[i], b[i]);
  uint32_t hi = addc(0, 0);
  cond_sub_p<12>(r, s, hi);
}

template <>
__device__ __forceinline__ void sub_mod<12>(uint32_t (&r)[12],
                                            const uint32_t (&a)[12],
                                            const uint32_t (&b)[12]) {
  const uint32_t q[12] = FQ_P_WORDS;
  uint32_t d[12];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 12; i++) d[i] = subc_cc(a[i], b[i]);
  uint32_t mask = subc(0, 0);           // all ones iff a < b: add q back
  r[0] = add_cc(d[0], q[0] & mask);
#pragma unroll
  for (int i = 1; i < 11; i++) r[i] = addc_cc(d[i], q[i] & mask);
  r[11] = addc(d[11], q[11] & mask);   // mod 2^384
}

// acc = x_j * bi at word pairs (j, j + 1), j = 0, 2, .., 10: no carries.
// Passing a pointer one word up gives the odd words' products.
__device__ __forceinline__ void fq_mul_row(uint32_t (&acc)[12],
                                           const uint32_t* x, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 12; j += 2) {
    acc[j] = mul_lo(x[j], bi);
    acc[j + 1] = mul_hi(x[j], bi);
  }
}

// acc += x_j * bi at word pairs (j, j + 1), j = 0, 2, .., 10: one carry
// chain, whose carry out of word 11 is left on the flag.
__device__ __forceinline__ void fq_mad_row(uint32_t (&acc)[12],
                                           const uint32_t* x, uint32_t bi) {
  acc[0] = mad_lo_cc(x[0], bi, acc[0]);
  acc[1] = madc_hi_cc(x[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < 12; j += 2) {
    acc[j] = madc_lo_cc(x[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(x[j], bi, acc[j + 1]);
  }
}

// acc = (acc >> 64) + x_j * bi at word pairs (j, j + 1) + the carry flag
// in: the odd accumulator of the row before, moved down one word pair.
__device__ __forceinline__ void fq_mad_row_shift(uint32_t (&acc)[12],
                                                 const uint32_t* x,
                                                 uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 10; j += 2) {
    acc[j] = madc_lo_cc(x[j], bi, acc[j + 2]);
    acc[j + 1] = madc_hi_cc(x[j], bi, acc[j + 3]);
  }
  acc[10] = madc_lo_cc(x[10], bi, 0);
  acc[11] = madc_hi(x[10], bi, 0);
}

// One CIOS row on the split accumulator V = even + 2^32 odd:
// V <- (V + a bi + m q) / 2^32 with m = -(V + a bi) q^-1 mod 2^32.  After
// the row `even` holds a zero low word and the result is
// odd + (even >> 32), so the caller swaps the two for the next row.  The
// top words stay small (q < 2^381), so no carry leaves word 12.
template <bool FIRST>
__device__ __forceinline__ void fq_row(uint32_t (&even)[12],
                                       uint32_t (&odd)[12],
                                       const uint32_t (&a)[12],
                                       const uint32_t (&q)[12],
                                       uint32_t bi) {
  if (FIRST) {
    fq_mul_row(odd, a + 1, bi);
    fq_mul_row(even, a, bi);
  } else {
    // the row before left V = even + (odd >> 32): its odd[1] joins
    // even[0], and the rest of odd moves down to one word up
    even[0] = add_cc(even[0], odd[1]);
    fq_mad_row_shift(odd, a + 1, bi);
    fq_mad_row(even, a, bi);
    odd[11] = addc(odd[11], 0);
  }
  uint32_t m = even[0] * FQ_N0;
  fq_mad_row(odd, q + 1, m);            // carry out is 0
  fq_mad_row(even, q, m);               // even[0] becomes 0
  odd[11] = addc(odd[11], 0);
}

template <>
__device__ __forceinline__ void mont_mul<12>(uint32_t (&r)[12],
                                             const uint32_t (&a)[12],
                                             const uint32_t (&b)[12]) {
  const uint32_t q[12] = FQ_P_WORDS;
  uint32_t even[12], odd[12];
  fq_row<true>(even, odd, a, q, b[0]);
  fq_row<false>(odd, even, a, q, b[1]);
#pragma unroll
  for (int i = 2; i < 12; i += 2) {
    fq_row<false>(even, odd, a, q, b[i]);
    fq_row<false>(odd, even, a, q, b[i + 1]);
  }
  // V = even + (odd >> 32) < 2q
  even[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < 11; j++) even[j] = addc_cc(even[j], odd[j + 1]);
  even[11] = addc(even[11], 0);
  cond_sub_p<12>(r, even, 0);
}
