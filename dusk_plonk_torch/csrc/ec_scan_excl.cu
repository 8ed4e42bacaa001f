// K4: per-lane exclusive prefix scan of complete G1 additions.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::ec_scan_excl14
// (_ec_scan_excl14_kernel): the Pippenger chunk offsets, the exclusive
// prefix of each window's chunk totals (ops/msm.py::MsmPlan.
// _window_group_totals).  The TPU kernel ran in the 14-bit R = 2^392
// engine; here the same group elements come from ec.cuh's RCB15 add over
// 32-bit words.
//
// Input: three (steps, 24, lanes) planes; output: three (steps, 24, lanes)
// planes with out_0 = identity (0, 1, 0) and out_s = g_0 + ... + g_{s-1}.
//
// Bound on the H100: the serial step chain.  At the MSM's shape (257 steps,
// one lane per (commit, window): 20 lanes a commit) the card runs a few
// warps, each thread doing 257 dependent adds of 12 Fq multiplies; neither
// HBM (72 words in and out a step) nor the ALU of the whole card is near
// its limit.  Design: one thread per lane, accumulator in registers, the
// store of step s before the add of g_s.  A parallel associative scan over
// the step axis is the lever for a later change.

#include "ec.cuh"

__global__ void __launch_bounds__(128)
ec_scan_excl_kernel(const uint32_t* __restrict__ gx,
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
    store_limbs<12>(ox + off, lanes, acc.x);
    store_limbs<12>(oy + off, lanes, acc.y);
    store_limbs<12>(oz + off, lanes, acc.z);
    load_limbs<12>(q.x, gx + off, lanes);
    load_limbs<12>(q.y, gy + off, lanes);
    load_limbs<12>(q.z, gz + off, lanes);
    g1_add(acc, acc, q);
  }
}

extern "C" int dt_ec_scan_excl(const void* gx, const void* gy, const void* gz,
                               void* ox, void* oy, void* oz, int steps,
                               int64_t lanes, void* stream) {
  if (lanes > 0 && steps > 0) {
    int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    ec_scan_excl_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)gx, (const uint32_t*)gy, (const uint32_t*)gz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, steps, lanes);
  }
  return (int)cudaGetLastError();
}
