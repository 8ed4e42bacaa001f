// K7: per-lane 2^k a + b over G1.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::ec_double_add14
// (_ec_double_add14_kernel): the tail NB * full_sum - sum_d P(t_d) of the
// Pippenger bucket reduction (ops/msm.py::MsmPlan._window_group_totals; the
// caller negates b).  The TPU kernel doubles with the complete addition
// a + a; here each doubling is ec.cuh's g1_dbl (RCB15 algorithm 9, 8 Fq
// multiplies against 12), then one g1_add.  The output is the TPU kernel's
// group element in another projective representative; the plain version
// (ops/kernels.py::ec_double_add_plain, DeviceG1.double_formula) runs the
// same formulas, so it agrees limb for limb.
//
// Input and output: three (24, lanes) planes per point.
//
// Bound on the H100: the serial chain of k doublings and one add per lane.
// At the MSM's shape (k = 12 on one lane per (commit, window): 20 lanes a
// commit) a few warps run; neither HBM nor the card's ALU is near its
// limit, so the chain's latency is the time.  Design: one thread per lane;
// the cheaper doubling shortens the chain by a third; b is loaded only
// after the doubling loop, so the loop keeps one point and the doubling's
// temporaries live.

#include "ec.cuh"

__global__ void __launch_bounds__(128)
ec_double_add_kernel(const uint32_t* __restrict__ ax,
                     const uint32_t* __restrict__ ay,
                     const uint32_t* __restrict__ az,
                     const uint32_t* __restrict__ bx,
                     const uint32_t* __restrict__ by,
                     const uint32_t* __restrict__ bz, uint32_t* __restrict__ ox,
                     uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                     int k, int64_t lanes) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  G1Proj acc;
  load_limbs<12>(acc.x, ax + lane, lanes);
  load_limbs<12>(acc.y, ay + lane, lanes);
  load_limbs<12>(acc.z, az + lane, lanes);
  for (int i = 0; i < k; i++) g1_dbl(acc, acc);
  G1Proj q;
  load_limbs<12>(q.x, bx + lane, lanes);
  load_limbs<12>(q.y, by + lane, lanes);
  load_limbs<12>(q.z, bz + lane, lanes);
  g1_add(acc, acc, q);
  store_limbs<12>(ox + lane, lanes, acc.x);
  store_limbs<12>(oy + lane, lanes, acc.y);
  store_limbs<12>(oz + lane, lanes, acc.z);
}

extern "C" int dt_ec_double_add(const void* ax, const void* ay, const void* az,
                                const void* bx, const void* by, const void* bz,
                                void* ox, void* oy, void* oz, int k,
                                int64_t lanes, void* stream) {
  if (lanes > 0) {
    int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    ec_double_add_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)ax, (const uint32_t*)ay, (const uint32_t*)az,
        (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, k, lanes);
  }
  return (int)cudaGetLastError();
}
