// The Fr multiply's own rate on the card, for reading K14's times:
// every thread runs ILP independent chains x_k = x_k * y of `iters`
// multiplies, either quotient.cuh::fr_mont_mul (Fr's shape) or
// field.cuh::mont_mul<8>, in blocks of 128.  `smem` bytes of dynamic
// shared memory a block (unused) cap the blocks an SM, so the same
// multiply is timed at several occupancies.  quotient_variants.py
// launches it; the chains' last values are written out so that nothing
// is optimised away.

#include "quotient.cuh"

template <int ILP, bool SHAPED>
__global__ void __launch_bounds__(128)
fr_mul_peak_kernel(uint32_t* out, int iters) {
  extern __shared__ uint32_t pad[];
  uint32_t x[ILP][8], y[8];
  uint32_t s = blockIdx.x * 128u + threadIdx.x;
#pragma unroll
  for (int w = 0; w < 8; w++) {
    y[w] = (s * 2654435761u) ^ (w * 40503u);
#pragma unroll
    for (int k = 0; k < ILP; k++) x[k][w] = (s + k) * 747796405u + w;
  }
  y[7] &= 0x0fffffffu;                  // canonical: below r's top word
#pragma unroll
  for (int k = 0; k < ILP; k++) x[k][7] &= 0x0fffffffu;
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int k = 0; k < ILP; k++) {
      if (SHAPED)
        fr_mont_mul(x[k], x[k], y);
      else
        mont_mul<8>(x[k], x[k], y);
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < ILP; k++)
#pragma unroll
    for (int w = 0; w < 8; w++) acc ^= x[k][w];
  if (iters < 0) pad[0] = acc;          // never: keeps the pad declared
  out[s] = acc;
}

template <int ILP, bool SHAPED>
static int launch(uint32_t* out, int iters, int blocks, int smem,
                  cudaStream_t st) {
  cudaFuncSetAttribute(fr_mul_peak_kernel<ILP, SHAPED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fr_mul_peak_kernel<ILP, SHAPED><<<blocks, 128, smem, st>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int dt_fr_mul_peak(void* out, int iters, int ilp, int shaped,
                              int blocks, int smem, void* stream) {
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (shaped) {
    if (ilp == 1) return launch<1, true>(o, iters, blocks, smem, st);
    if (ilp == 2) return launch<2, true>(o, iters, blocks, smem, st);
    if (ilp == 4) return launch<4, true>(o, iters, blocks, smem, st);
  } else {
    if (ilp == 1) return launch<1, false>(o, iters, blocks, smem, st);
    if (ilp == 2) return launch<2, false>(o, iters, blocks, smem, st);
    if (ilp == 4) return launch<4, false>(o, iters, blocks, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
