// K13: signed int32 digit-product planes -> canonical Fr Montgomery limbs,
// the back half of the four-step NTT's modular matrix product.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/mxu_ntt.py::reduce_planes
// (_reduce_kernel, mxu_ntt.py:127-161), reached through
// ops/mxu_ntt.py::mod_matmul.  Element j of row r holds 65 planes
// P_0 .. P_64 (int32, signed: products of balanced base-256 digits, summed
// over the contraction) with a non-negative total
//   T = sum_s P_s 2^(8s) < 2^272 p,
// and the kernel writes T 2^-272 mod p, canonical, as 16 16-bit limbs --
// limb for limb the JAX function's output.
//
// Arithmetic: the signed 65-step carry sweep (arithmetic shifts) turns the
// planes into 68 base-256 digits, packed straight into 17 32-bit words;
// then a word-serial Montgomery reduction by R' = 2^272: eight 32-bit
// steps and one 16-bit step build the same m = -T p^-1 mod 2^272 as the
// JAX kernel's wide product, so (T + m p) / 2^272 < 2p is the same value,
// and one conditional subtraction makes it canonical.
//
// Bound on the H100: HBM.  Each element reads 260 bytes and writes 64
// against ~80 32x32 multiplies.  Design: one thread per element, the
// whole sweep and reduction in registers; every plane read is coalesced
// (neighbouring threads on neighbouring elements).  One launch covers all
// leading rows, where the JAX package launched once per row.

#include "field.cuh"

static constexpr int NPLANES = 65;

__global__ void __launch_bounds__(256)
reduce_planes_kernel(const int32_t* __restrict__ planes,
                     uint32_t* __restrict__ out, int64_t rows, int64_t n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  int64_t r = idx / n;
  int64_t j = idx - r * n;
  const int32_t* src = planes + r * NPLANES * n + j;

  // signed carry sweep: digit s is byte s & 3 of word s >> 2
  uint32_t t[18];
#pragma unroll
  for (int w = 0; w < 18; w++) t[w] = 0;
  int32_t carry = 0;
#pragma unroll
  for (int s = 0; s < NPLANES; s++) {
    int32_t v = src[s * n] + carry;
    t[s >> 2] |= (uint32_t)(v & 0xff) << (8 * (s & 3));
    carry = v >> 8;                      // arithmetic shift
  }
  // the total is non-negative: the last carry is in [0, 2^24) and gives
  // digits 65..67, bytes 1..3 of word 16
  t[16] |= ((uint32_t)carry & 0xffffffu) << 8;

  // Montgomery reduction by 2^272: eight 32-bit steps ...
  const uint32_t p[8] = FR_P_WORDS;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t m = t[i] * FR_N0;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      c += (uint64_t)m * p[k] + t[i + k];
      t[i + k] = (uint32_t)c;
      c >>= 32;
    }
#pragma unroll
    for (int k = i + 8; k < 18; k++) {
      c += t[k];
      t[k] = (uint32_t)c;
      c >>= 32;
    }
  }
  // ... and one 16-bit step (FR_N0's low half is -p^-1 mod 2^16)
  {
    uint32_t m = (t[8] * FR_N0) & 0xffffu;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      c += (uint64_t)m * p[k] + t[8 + k];
      t[8 + k] = (uint32_t)c;
      c >>= 32;
    }
#pragma unroll
    for (int k = 16; k < 18; k++) {
      c += t[k];
      t[k] = (uint32_t)c;
      c >>= 32;
    }
  }
  // (T + m p) / 2^272 = words 8.. shifted down by 16 bits, < 2p < 2^256
  uint32_t h[8];
#pragma unroll
  for (int w = 0; w < 8; w++) h[w] = (t[8 + w] >> 16) | (t[9 + w] << 16);
  uint32_t res[8];
  cond_sub_p<8>(res, h, 0u);
  store_limbs<8>(out + r * 16 * n + j, n, res);
}

extern "C" int dt_reduce_planes(const void* planes, void* out, int64_t rows,
                                int64_t n, void* stream) {
  int64_t total = rows * n;
  if (total > 0) {
    int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    reduce_planes_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)planes, (uint32_t*)out, rows, n);
  }
  return (int)cudaGetLastError();
}
