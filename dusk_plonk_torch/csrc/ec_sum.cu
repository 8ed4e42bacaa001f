// K11b / K6: per-lane sum of complete G1 additions along a step axis.
//
// Replaces the TPU kernels dusk_plonk_tpu/ops/pallas_field.py::ec_sum_steps
// (_ec_sum_kernel, 16-bit limbs) and ::ec_sum_steps14 (_ec_sum14_kernel, the
// 14-bit R = 2^392 engine of the default configuration): the two levels of
// the Pippenger bucket sum (ops/msm.py::MsmPlan._window_group_totals).  The
// 14-bit engine was a TPU workaround for the missing 32x32->64 multiply;
// the group elements are the same, so one kernel serves both rows.
//
// Input: three (steps, 24, lanes) planes of projective points; output: three
// (24, lanes) planes, acc = g_0 + g_1 + ... + g_{steps-1} from the identity,
// in the order of ec.cuh's RCB15 add (the plain version repeats it).
//
// Bound on the H100: integer ALU and registers (12 Fq Montgomery multiplies
// per step against 288 bytes read).  Design: the Pallas grid's sequential
// step axis becomes a loop inside one thread per lane; the 36-word
// accumulator never leaves registers.  Neighbouring threads read
// neighbouring lanes of each limb row.  At the MSM's shapes (level 1:
// 64 steps on 1,280 lanes a commit; level 2: 64 steps on 20) the lane count,
// not the ALU, sets the time: a few warps on 132 SMs.

#include "ec.cuh"

__global__ void __launch_bounds__(128)
ec_sum_steps_kernel(const uint32_t* __restrict__ gx,
                    const uint32_t* __restrict__ gy,
                    const uint32_t* __restrict__ gz, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int steps, int64_t lanes) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  G1Proj acc, q;
  g1_set_identity(acc);
  for (int s = 0; s < steps; s++) {
    int64_t off = (int64_t)s * 24 * lanes + lane;
    load_limbs<12>(q.x, gx + off, lanes);
    load_limbs<12>(q.y, gy + off, lanes);
    load_limbs<12>(q.z, gz + off, lanes);
    g1_add(acc, acc, q);
  }
  store_limbs<12>(ox + lane, lanes, acc.x);
  store_limbs<12>(oy + lane, lanes, acc.y);
  store_limbs<12>(oz + lane, lanes, acc.z);
}

extern "C" int dt_ec_sum_steps(const void* gx, const void* gy, const void* gz,
                               void* ox, void* oy, void* oz, int steps,
                               int64_t lanes, void* stream) {
  if (lanes > 0) {
    int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    ec_sum_steps_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)gx, (const uint32_t*)gy, (const uint32_t*)gz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, steps, lanes);
  }
  return (int)cudaGetLastError();
}
