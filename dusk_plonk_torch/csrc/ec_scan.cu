// K11a: per-lane inclusive prefix scan of complete mixed G1 additions.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::ec_scan_mixed
// (_ec_scan_mixed_kernel), the 16-bit chunk scan of the Pippenger MSM, and
// its 14-bit twin ::ec_scan_mixed14 (_ec_scan_mixed14_kernel) of the
// default configuration (ops/msm.py::MsmPlan._window_group_totals); the
// group elements are the same.
//
// Input g is (cl, 48, lanes): for step s, rows 0..23 hold the affine x and
// rows 24..47 the affine y of the point added on each lane.  Output is
// three (cl, 24, lanes) planes, the running sum after each step, starting
// from the identity: acc_s = acc_{s-1} + g_s.
//
// Bound on the H100: integer ALU and registers (11 Fq Montgomery
// multiplies per step) -- the TPU kernel carried the accumulator in VMEM
// across a sequential grid axis; here the step loop runs inside the thread
// and the 36-word accumulator never leaves registers.  Design: one thread
// per lane; each step reads 48 words and writes 72, with neighbouring
// threads on neighbouring lanes.  __launch_bounds__(128) allows 255
// registers a thread for the RCB15 temporaries.  Parallelism is the lane
// count (commits x windows x chunks), which the MSM keeps in the thousands.

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
