// K8: the Pippenger window combine, acc = 2^c acc + T_w, MSB window first.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::ec_combine14
// (_ec_combine14_kernel), which ops/msm.py::MsmPlan.msm_device runs after
// the window totals.  As in the TPU kernel, each doubling is the complete
// addition acc + acc, starting from the identity.
//
// Input: three (W, 24, lanes) planes of window totals, MSB window first;
// output: three (24, lanes) planes, sum_w 2^(c (W-1-w)) T_w.
//
// Bound on the H100: the serial chain (W (c + 1) dependent adds: 280 for
// W = 20, c = 13) on one thread per MSM.  One lane is one warp on one SM;
// HBM traffic is W * 72 words.  Design: one thread per lane, the whole
// ladder in registers.  The prover combines on the host instead
// (native g1_combine_windows), as the JAX prover does.

#include "ec.cuh"

__global__ void __launch_bounds__(128)
ec_combine_kernel(const uint32_t* __restrict__ gx,
                  const uint32_t* __restrict__ gy,
                  const uint32_t* __restrict__ gz, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                  int windows, int c, int64_t lanes) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  G1Proj acc, t;
  g1_set_identity(acc);
  for (int w = 0; w < windows; w++) {
    for (int i = 0; i < c; i++) g1_add(acc, acc, acc);
    int64_t off = (int64_t)w * 24 * lanes + lane;
    load_limbs<12>(t.x, gx + off, lanes);
    load_limbs<12>(t.y, gy + off, lanes);
    load_limbs<12>(t.z, gz + off, lanes);
    g1_add(acc, acc, t);
  }
  store_limbs<12>(ox + lane, lanes, acc.x);
  store_limbs<12>(oy + lane, lanes, acc.y);
  store_limbs<12>(oz + lane, lanes, acc.z);
}

extern "C" int dt_ec_combine(const void* gx, const void* gy, const void* gz,
                             void* ox, void* oy, void* oz, int windows, int c,
                             int64_t lanes, void* stream) {
  if (lanes > 0) {
    int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    ec_combine_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)gx, (const uint32_t*)gy, (const uint32_t*)gz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, windows, c, lanes);
  }
  return (int)cudaGetLastError();
}
