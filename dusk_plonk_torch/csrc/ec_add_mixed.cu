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
// Bound on the H100: at the per-step route's 148 lanes neither the integer
// ALU nor the 384 bytes a lane, but one launch of a chain of dependent Fq
// multiplies: 11 on one thread a lane.  Design: a team of T = 6 threads of
// one warp a lane (ec.cuh::g1_add_mixed_team): each level of independent
// multiplies (5, then 6) dealt out one to a thread, so the chain is two
// dependent multiplies plus the adds and two __syncwarp round trips.  One
// warp a block, 32 / T lanes a warp; rank c % T stores coordinate c, pad
// threads store nothing.  Every product is canonical, so the output is
// g1_add_mixed's limb for limb.  (One thread a lane, and teams of 2 and 3:
// tools/kernel_variants/k12_variants.py.)

#include "ec.cuh"

template <int T>
__global__ void __launch_bounds__(32)
ec_add_mixed_kernel(const uint32_t* __restrict__ px,
                    const uint32_t* __restrict__ py,
                    const uint32_t* __restrict__ pz,
                    const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int64_t rows, int64_t n) {
  constexpr int LANES = 32 / T;                    // lanes a warp
  constexpr int TEAMS = (32 + T - 1) / T;          // teams a warp, pads too
  constexpr int STRIDE = TEAMS * TEAM_SLOTS;
  __shared__ uint32_t scratch[12 * STRIDE];
  int team = threadIdx.x / T;
  int rank = threadIdx.x - team * T;
  int64_t total = rows * n;
  int64_t idx = (int64_t)blockIdx.x * LANES + team;
  bool owner = team < LANES && idx < total;
  if (idx >= total) idx = total - 1;               // a copy, stored by none
  int64_t r = idx / n;
  int64_t off = r * 24 * n + (idx - r * n);
  G1Proj p;
  Fq x2, y2;
  load_point(p, px, py, pz, off, n);
  load_limbs<12>(x2, qx + off, n);
  load_limbs<12>(y2, qy + off, n);
  g1_add_mixed_team<T>(p, p, x2, y2, rank, scratch + team * TEAM_SLOTS,
                       STRIDE);
  if (owner) {
    if (rank == 0) store_limbs<12>(ox + off, n, p.x);
    if (rank == 1 % T) store_limbs<12>(oy + off, n, p.y);
    if (rank == 2 % T) store_limbs<12>(oz + off, n, p.z);
  }
}

template <int T>
static void launch(const void* px, const void* py, const void* pz,
                   const void* qx, const void* qy, void* ox, void* oy,
                   void* oz, int64_t rows, int64_t n, cudaStream_t stream) {
  int64_t blocks = (rows * n + 32 / T - 1) / (32 / T);
  ec_add_mixed_kernel<T><<<(unsigned)blocks, 32, 0, stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
      (const uint32_t*)qx, (const uint32_t*)qy, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, rows, n);
}

extern "C" int dt_ec_add_mixed(const void* px, const void* py,
                               const void* pz, const void* qx,
                               const void* qy, void* ox, void* oy, void* oz,
                               int64_t rows, int64_t n, void* stream) {
  if (rows * n > 0)
    launch<6>(px, py, pz, qx, qy, ox, oy, oz, rows, n, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
