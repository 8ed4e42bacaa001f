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
// lazy-carry schedule of the JAX kernels becomes a plain CIOS loop over
// 32-bit words with 64-bit accumulators.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

static __constant__ uint32_t FR_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static constexpr uint32_t FR_N0 = 0xffffffffu;  // -p^-1 mod 2^32

static __constant__ uint32_t FQ_P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static constexpr uint32_t FQ_N0 = 0xfffcfffdu;

// Montgomery 1 (R mod q), the Y of the projective identity (0, 1, 0).
static __constant__ uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

template <int NW>
struct FieldTraits;

template <>
struct FieldTraits<8> {
  static __device__ __forceinline__ uint32_t p(int i) { return FR_P[i]; }
  static constexpr uint32_t n0 = FR_N0;
};

template <>
struct FieldTraits<12> {
  static __device__ __forceinline__ uint32_t p(int i) { return FQ_P[i]; }
  static constexpr uint32_t n0 = FQ_N0;
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
