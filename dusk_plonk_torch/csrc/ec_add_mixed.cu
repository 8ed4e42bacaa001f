// K10: elementwise complete mixed G1 addition, p projective + q affine.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::ec_add_mixed
// (_ec_add_mixed_kernel), reached through ops/ec.py::DeviceG1.add_mixed.
// The JAX MSM takes that route on its per-step chunk scan when the scan's
// lane count is not a multiple of the TPU's 128-lane tile
// (ops/msm.py:297-304); the port's K11a / K12 scans take every lane count,
// so here K10 serves DeviceG1.add_mixed itself.
//
// Inputs: p as three (rows, 24, n) planes, q as two (x, y) planes of the
// same shape, strictly affine (z = 1, never the identity).  Output: three
// planes, RCB15's 11-multiply mixed formula (ec.cuh::g1_add_mixed), limb
// for limb the JAX kernel's result.
//
// Bound on the H100: integer ALU.  One mixed add is 11 Fq Montgomery
// multiplies (3,300 32x32 multiplies) against 384 bytes of traffic.
// Design: as K9, one thread per lane with the formula in registers,
// __launch_bounds__(128) for the RCB15 temporaries; neighbouring threads
// read neighbouring words of each limb plane.

#include "ec.cuh"

__global__ void __launch_bounds__(128)
ec_add_mixed_kernel(const uint32_t* __restrict__ px,
                    const uint32_t* __restrict__ py,
                    const uint32_t* __restrict__ pz,
                    const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int64_t rows, int64_t n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  int64_t r = idx / n;
  int64_t j = idx - r * n;
  int64_t off = r * 24 * n + j;
  G1Proj p;
  Fq x2, y2;
  load_limbs<12>(p.x, px + off, n);
  load_limbs<12>(p.y, py + off, n);
  load_limbs<12>(p.z, pz + off, n);
  load_limbs<12>(x2, qx + off, n);
  load_limbs<12>(y2, qy + off, n);
  g1_add_mixed(p, p, x2, y2);
  store_limbs<12>(ox + off, n, p.x);
  store_limbs<12>(oy + off, n, p.y);
  store_limbs<12>(oz + off, n, p.z);
}

extern "C" int dt_ec_add_mixed(const void* px, const void* py,
                               const void* pz, const void* qx,
                               const void* qy, void* ox, void* oy, void* oz,
                               int64_t rows, int64_t n, void* stream) {
  int64_t total = rows * n;
  if (total > 0) {
    int threads = 128;
    int64_t blocks = (total + threads - 1) / threads;
    ec_add_mixed_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
        (const uint32_t*)qx, (const uint32_t*)qy, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, rows, n);
  }
  return (int)cudaGetLastError();
}
