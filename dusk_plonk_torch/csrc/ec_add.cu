// K9: elementwise complete projective G1 addition over Fq limb planes.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::ec_add
// (_ec_add_kernel), reached through ops/ec.py::DeviceG1.add, and its 14-bit
// twin ::ec_add14 (_ec_add14_kernel; the R = 2^392 engine was a TPU
// workaround and gives the same group elements).  In the MSM (ops/msm.py)
// it reads the bucket tails, scan value + chunk offset; in
// kzg/srs.py::PlonkParams.setup_device it sums the 32 window gathers.
//
// Bound on the H100: the integer multiply issue rate.  One add is 12 Fq
// Montgomery multiplies (300 32x32->64 products each, a mad.lo and a
// mad.hi instruction apiece) and ~20 modular adds against 432 bytes of
// traffic, so the multiply instructions (~0.035 ms at 81,940 lanes) cost
// more than the bytes (0.021 ms).  Design: one thread per lane, the whole
// RCB15 formula in registers (ec.cuh::g1_add); neighbouring threads read
// neighbouring words.  The formula keeps ten 12-word Fq temporaries plus
// both operands live (186 registers unbounded: 2 blocks, 8 warps an SM,
// too few to hide the carry chains); __launch_bounds__(128, 3) holds it
// to 168 registers with a 32-byte spill for 12 warps an SM, 17% faster at
// 81,940 lanes and 12% at 327,760 (tools/kernel_variants/k9_variants.py:
// 4 blocks an SM at 128 registers, a team of threads a lane (about twice
// the instructions a lane) and interleaved multiplies were all slower).
// Inputs are (rows, 24, n) planes; lane (r, j) reads limb l at
// r * 24 n + l n + j.

#include "ec.cuh"

__global__ void __launch_bounds__(128, 3)
ec_add_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
              const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
              const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
              uint32_t* __restrict__ oz, int64_t rows, int64_t n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  int64_t r = idx / n;
  int64_t j = idx - r * n;
  int64_t off = r * 24 * n + j;
  G1Proj p, q;
  load_limbs<12>(p.x, px + off, n);
  load_limbs<12>(p.y, py + off, n);
  load_limbs<12>(p.z, pz + off, n);
  load_limbs<12>(q.x, qx + off, n);
  load_limbs<12>(q.y, qy + off, n);
  load_limbs<12>(q.z, qz + off, n);
  g1_add(p, p, q);
  store_limbs<12>(ox + off, n, p.x);
  store_limbs<12>(oy + off, n, p.y);
  store_limbs<12>(oz + off, n, p.z);
}

extern "C" int dt_ec_add(const void* px, const void* py, const void* pz,
                         const void* qx, const void* qy, const void* qz,
                         void* ox, void* oy, void* oz, int64_t rows,
                         int64_t n, void* stream) {
  int64_t total = rows * n;
  if (total > 0) {
    int threads = 128;
    int64_t blocks = (total + threads - 1) / threads;
    ec_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
        (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)qz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, rows, n);
  }
  return (int)cudaGetLastError();
}
