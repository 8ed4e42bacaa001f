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
// lazy-carry schedule of the JAX kernels becomes word arithmetic on PTX
// carry-flag chains (ptx.cuh): each word step is one instruction on the
// carry flag, and the modulus words are immediates.  One template serves
// both fields; NW is the word count (8: Fr, 12: Fq).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

// The moduli, -p^-1 mod 2^32, and Fq's Montgomery 1 (R mod q, the Y of the
// projective identity (0, 1, 0)) as immediates: every caller indexes them
// with a constant after unrolling, so each word folds into the instruction
// that uses it.
#define FR_P_WORDS                                                   \
  {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u,  \
   0x3339d808u, 0x299d7d48u, 0x73eda753u}
#define FQ_P_WORDS                                                   \
  {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,  \
   0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,  \
   0x397fe69au, 0x1a0111eau}
#define FQ_ONE_WORDS                                                 \
  {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,  \
   0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,  \
   0xfa80e493u, 0x15f65ec3u}

static constexpr uint32_t FR_N0 = 0xffffffffu;
static constexpr uint32_t FQ_N0 = 0xfffcfffdu;

template <int NW>
struct Modulus;

template <>
struct Modulus<8> {
  static constexpr uint32_t n0 = FR_N0;
  static __device__ __forceinline__ void words(uint32_t (&p)[8]) {
    const uint32_t w[8] = FR_P_WORDS;
#pragma unroll
    for (int i = 0; i < 8; i++) p[i] = w[i];
  }
};

template <>
struct Modulus<12> {
  static constexpr uint32_t n0 = FQ_N0;
  static __device__ __forceinline__ void words(uint32_t (&p)[12]) {
    const uint32_t w[12] = FQ_P_WORDS;
#pragma unroll
    for (int i = 0; i < 12; i++) p[i] = w[i];
  }
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
//
// Every input must be canonical (< p), as every value of the kernels is.

// r = a - p if hi:a >= p else a  (one conditional subtraction, as
// LimbField._cond_sub_mod); `hi` is a carry word above the top word.
template <int NW>
__device__ __forceinline__ void cond_sub_p(uint32_t (&r)[NW],
                                           const uint32_t (&a)[NW],
                                           uint32_t hi) {
  uint32_t p[NW];
  Modulus<NW>::words(p);
  uint32_t d[NW];
  d[0] = sub_cc(a[0], p[0]);
#pragma unroll
  for (int i = 1; i < NW; i++) d[i] = subc_cc(a[i], p[i]);
  // hi:a - p borrows iff hi:a < p; then the top word is all ones
  bool ge = subc(hi, 0) != 0xffffffffu;
#pragma unroll
  for (int i = 0; i < NW; i++) r[i] = ge ? d[i] : a[i];
}

template <int NW>
__device__ __forceinline__ void add_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW]) {
  uint32_t s[NW];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < NW; i++) s[i] = addc_cc(a[i], b[i]);
  uint32_t hi = addc(0, 0);
  cond_sub_p<NW>(r, s, hi);
}

template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[NW],
                                        const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW]) {
  uint32_t p[NW];
  Modulus<NW>::words(p);
  uint32_t d[NW];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < NW; i++) d[i] = subc_cc(a[i], b[i]);
  uint32_t mask = subc(0, 0);           // all ones iff a < b: add p back
  r[0] = add_cc(d[0], p[0] & mask);
#pragma unroll
  for (int i = 1; i < NW - 1; i++) r[i] = addc_cc(d[i], p[i] & mask);
  r[NW - 1] = addc(d[NW - 1], p[NW - 1] & mask);   // mod 2^(32 NW)
}

// -- Montgomery multiply (CIOS on two carry chains) ---------------------------------
//
// r = a b 2^(-32 NW) mod p.  The word-serial reduction builds the same
// m = -ab/p mod R as the JAX package's separated form, so (ab + mp) / R
// and its one conditional subtraction agree bit for bit.
//
// The multiply keeps the products of a's even and odd words in two
// accumulators (even: word pairs at positions 0..NW-1; odd: one word up),
// so each CIOS row is two independent carry chains that run side by side,
// and the rows swap the two arrays instead of shifting.
//
// Why no carry is lost.  Let t be the value before a row (t = 0 before the
// first).  A row computes t + a b_i + m p and divides by 2^32, so
// t < a + p after every row.  Within a row even + 2^32 odd equals
// t + a b_i + m p < (a + p) 2^32, even < 2^(32 NW) always (its carries move
// into odd), and every carry only adds to odd: so odd < a + p, and no carry
// leaves odd (the unread flag after m p's odd words, the madc.hi and addc
// into odd's top word) whenever a + p <= 2^(32 NW).  For canonical a that is
// 2p <= 2^(32 NW): Fr has r < 2^255 (one spare bit), Fq has q < 2^381.
// The result t < a + p < 2p is canonical after one conditional
// subtraction.  For any a < 2^(32 NW) - p and any b the value is the same
// as a 64-bit word loop's, which keeps every carry.

// acc = x_j * bi at word pairs (j, j + 1), j = 0, 2, .., NW-2: no carries.
// Passing a pointer one word up gives the odd words' products.
template <int NW>
__device__ __forceinline__ void mul_row(uint32_t (&acc)[NW], const uint32_t* x,
                                        uint32_t bi) {
#pragma unroll
  for (int j = 0; j < NW; j += 2) {
    acc[j] = mul_lo(x[j], bi);
    acc[j + 1] = mul_hi(x[j], bi);
  }
}

// acc += x_j * bi at word pairs (j, j + 1), j = 0, 2, .., NW-2: one carry
// chain, whose carry out of word NW-1 is left on the flag.
template <int NW>
__device__ __forceinline__ void mad_row(uint32_t (&acc)[NW], const uint32_t* x,
                                        uint32_t bi) {
  acc[0] = mad_lo_cc(x[0], bi, acc[0]);
  acc[1] = madc_hi_cc(x[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    acc[j] = madc_lo_cc(x[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(x[j], bi, acc[j + 1]);
  }
}

// acc = (acc >> 64) + x_j * bi at word pairs (j, j + 1) + the carry flag
// in: the odd accumulator of the row before, moved down one word pair.
template <int NW>
__device__ __forceinline__ void mad_row_shift(uint32_t (&acc)[NW],
                                              const uint32_t* x, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < NW - 2; j += 2) {
    acc[j] = madc_lo_cc(x[j], bi, acc[j + 2]);
    acc[j + 1] = madc_hi_cc(x[j], bi, acc[j + 3]);
  }
  acc[NW - 2] = madc_lo_cc(x[NW - 2], bi, 0);
  acc[NW - 1] = madc_hi(x[NW - 2], bi, 0);
}

// One CIOS row on the split accumulator V = even + 2^32 odd:
// V <- (V + a bi + m p) / 2^32 with m = -(V + a bi) p^-1 mod 2^32.  After
// the row `even` holds a zero low word and the result is
// odd + (even >> 32), so the caller swaps the two for the next row.
template <int NW, bool FIRST>
__device__ __forceinline__ void mont_row(uint32_t (&even)[NW],
                                         uint32_t (&odd)[NW],
                                         const uint32_t (&a)[NW],
                                         const uint32_t (&p)[NW],
                                         uint32_t bi) {
  if (FIRST) {
    mul_row<NW>(odd, a + 1, bi);
    mul_row<NW>(even, a, bi);
  } else {
    // the row before left V = even + (odd >> 32): its odd[1] joins
    // even[0], and the rest of odd moves down to one word up
    even[0] = add_cc(even[0], odd[1]);
    mad_row_shift<NW>(odd, a + 1, bi);
    mad_row<NW>(even, a, bi);
    odd[NW - 1] = addc(odd[NW - 1], 0);
  }
  uint32_t m = even[0] * Modulus<NW>::n0;
  mad_row<NW>(odd, p + 1, m);           // carry out is 0
  mad_row<NW>(even, p, m);              // even[0] becomes 0
  odd[NW - 1] = addc(odd[NW - 1], 0);
}

template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[NW],
                                         const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW]) {
  uint32_t p[NW];
  Modulus<NW>::words(p);
  uint32_t even[NW], odd[NW];
  mont_row<NW, true>(even, odd, a, p, b[0]);
  mont_row<NW, false>(odd, even, a, p, b[1]);
#pragma unroll
  for (int i = 2; i < NW; i += 2) {
    mont_row<NW, false>(even, odd, a, p, b[i]);
    mont_row<NW, false>(odd, even, a, p, b[i + 1]);
  }
  // V = even + (odd >> 32) < 2p
  even[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < NW - 1; j++) even[j] = addc_cc(even[j], odd[j + 1]);
  even[NW - 1] = addc(even[NW - 1], 0);
  cond_sub_p<NW>(r, even, 0);
}
