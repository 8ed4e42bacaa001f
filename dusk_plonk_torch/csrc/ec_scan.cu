// K11a: per-lane inclusive prefix scan of complete mixed G1 additions,
// limb-plane output.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::
// ec_scan_mixed (_ec_scan_mixed_kernel), the 16-bit chunk scan of the
// Pippenger MSM, and its 14-bit twin ::ec_scan_mixed14
// (_ec_scan_mixed14_kernel) of the default configuration
// (ops/msm.py::MsmPlan._window_group_totals); the group elements are the
// same.  The JAX 14-bit kernel returns the points projectively scaled by
// 2^8; this returns the 16-bit engine's own triples (the same points).
// K12, the same scan with element-major output, is ec_scan_em.cu.
//
// Input g is (cl, 48, lanes): for step s, rows 0..23 hold the affine x and
// rows 24..47 the affine y of the point added on each lane.  The running
// sum after each step, from the identity (acc_s = acc_{s-1} + g_s), goes
// to three (cl, 24, lanes) planes.
//
// Bound on the H100: the latency of one thread's chain of 256 dependent
// mixed adds (11 Fq multiplies each), not the card's throughput: at the
// proof's 5,140-20,560 lanes the kernel runs at 8-25% of the 32-bit
// multiply rate, and the time grows little with the lane count.  The TPU
// kernel carried the accumulator in VMEM across a sequential grid axis;
// here the step loop runs inside the thread and the 36-word accumulator
// never leaves registers.  Design: one thread per lane, the step-by-step
// order of the JAX kernel (so the output is its plain version's, limb for
// limb), and the chain made short in time instead: the Fq multiply, whose
// dependent word steps set the step time, runs on two interleaved PTX
// carry chains with immediate modulus words (field.cuh).  Each step
// reads 48 words and writes 72.  Reads and writes are coalesced
// (neighbouring threads on neighbouring lanes).
// __launch_bounds__(128): 182 registers, no spill; (128, 3) caps them at
// 168 and spills, and was slower.  128-thread blocks.

#include "ec.cuh"

__global__ void __launch_bounds__(128)
ec_scan_mixed_kernel(const uint32_t* __restrict__ g, uint32_t* __restrict__ ox,
                     uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                     int cl, int64_t lanes) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  G1Proj acc;
  g1_set_identity(acc);
  for (int s = 0; s < cl; s++) {
    const uint32_t* src = g + (int64_t)s * 48 * lanes + lane;
    Fq x2, y2;
    load_limbs<12>(x2, src, lanes);
    load_limbs<12>(y2, src + 24 * lanes, lanes);
    g1_add_mixed(acc, acc, x2, y2);
    int64_t off = (int64_t)s * 24 * lanes + lane;
    store_limbs<12>(ox + off, lanes, acc.x);
    store_limbs<12>(oy + off, lanes, acc.y);
    store_limbs<12>(oz + off, lanes, acc.z);
  }
}

extern "C" int dt_ec_scan_mixed(const void* g, void* ox, void* oy, void* oz,
                                int cl, int64_t lanes, void* stream) {
  if (lanes > 0 && cl > 0) {
    int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    ec_scan_mixed_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)g, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, cl,
        lanes);
  }
  return (int)cudaGetLastError();
}
