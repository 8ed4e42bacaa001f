// K1: batched Montgomery multiply over Fr or Fq limb planes.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::mont_mul
// (_mul_kernel; also fr_mul / fq_mul), reached through
// ops/limb.py::LimbField.mul.
//
// Bound on the H100: integer ALU.  One Fr multiply is 128 32x32->64
// multiply-adds against 96 bytes of traffic (a, b, out), so the SMs'
// integer pipes, not HBM, set the rate at every size the prover uses.
// Design: one thread per element, the whole multiply in registers
// (field.cuh: the CIOS loop for Fr, carry-flag chains for Fq), no shared
// memory.  Operands may broadcast: each input has
// its own (row, limb, element) strides, and a stride of 0 reuses one
// element, so an (L, 1) scalar never expands into an (L, N) copy.
// Neighbouring threads read neighbouring elements of each limb plane.

#include "field.cuh"

template <int NW>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const uint32_t* __restrict__ a, int64_t sa_row,
                int64_t sa_limb, int64_t sa_elem,
                const uint32_t* __restrict__ b, int64_t sb_row,
                int64_t sb_limb, int64_t sb_elem,
                uint32_t* __restrict__ out, int64_t rows, int64_t n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  int64_t r = idx / n;
  int64_t j = idx - r * n;
  uint32_t x[NW], y[NW], z[NW];
  load_limbs<NW>(x, a + r * sa_row + j * sa_elem, sa_limb);
  load_limbs<NW>(y, b + r * sb_row + j * sb_elem, sb_limb);
  mont_mul<NW>(z, x, y);
  store_limbs<NW>(out + r * (2 * NW) * n + j, n, z);
}

template <int NW>
static int launch(const void* a, int64_t sa_row, int64_t sa_limb,
                  int64_t sa_elem, const void* b, int64_t sb_row,
                  int64_t sb_limb, int64_t sb_elem, void* out, int64_t rows,
                  int64_t n, void* stream) {
  int64_t total = rows * n;
  if (total > 0) {
    int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    mont_mul_kernel<NW><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa_row, sa_limb, sa_elem, (const uint32_t*)b,
        sb_row, sb_limb, sb_elem, (uint32_t*)out, rows, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int dt_mont_mul(int limbs, const void* a, int64_t sa_row,
                           int64_t sa_limb, int64_t sa_elem, const void* b,
                           int64_t sb_row, int64_t sb_limb, int64_t sb_elem,
                           void* out, int64_t rows, int64_t n,
                           void* stream) {
  if (limbs == 16)
    return launch<8>(a, sa_row, sa_limb, sa_elem, b, sb_row, sb_limb,
                     sb_elem, out, rows, n, stream);
  if (limbs == 24)
    return launch<12>(a, sa_row, sa_limb, sa_elem, b, sb_row, sb_limb,
                      sb_elem, out, rows, n, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
