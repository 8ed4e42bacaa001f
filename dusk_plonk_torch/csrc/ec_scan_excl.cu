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
// Bound on the H100: the dependent chain of adds.  At the MSM's shape (257
// steps, one lane per (commit, window): 20 lanes a commit) neither HBM (72
// words in and out a step) nor the card's ALU is near its limit, and one
// thread per lane would run all 257 adds in one dependent chain.
// Design: a block-parallel scan over the step axis.  One block of T
// threads per lane; thread r owns the run of steps [r m, (r + 1) m) (T and
// m from ops/kernels.py::_excl_block; a run past `steps` is empty).
//   1. each thread sums its run from the identity, in registers;
//   2. the block scans the T run totals in shared memory (Hillis-Steele,
//      v_r <- v_{r-d} + v_r at d = 1, 2, 4, .. < T);
//   3. each thread starts from its exclusive offset v_{r-1} (identity for
//      run 0) and stores its run's prefixes, adding g_s after each store.
// The dependent depth is 2m + log2 T adds (13 at 257 steps, T = 128)
// instead of `steps`; the extra work (~5x the adds) is free at 20-300
// lanes.  The outputs are the sequential scan's group elements in other
// projective representatives; ops/kernels.py::ec_scan_excl_plain with
// block = (T, m) repeats this order add for add.

#include "ec.cuh"

__global__ void __launch_bounds__(128)
ec_scan_excl_kernel(const uint32_t* __restrict__ gx,
                    const uint32_t* __restrict__ gy,
                    const uint32_t* __restrict__ gz, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int steps, int64_t lanes, int m) {
  extern __shared__ uint32_t tot[];                 // 36 words x T
  const int T = blockDim.x;
  const int r = threadIdx.x;
  const int64_t lane = blockIdx.x;
  const int s0 = min(r * m, steps);
  const int s1 = min(s0 + m, steps);
  G1Proj acc, q;

  // 1. the run's total
  g1_set_identity(acc);
  for (int s = s0; s < s1; s++) {
    load_point(q, gx, gy, gz, (int64_t)s * 24 * lanes + lane, lanes);
    g1_add(acc, acc, q);
  }

  // 2. inclusive scan of the run totals
  put_point(tot, T, r, acc);
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    if (r >= d) get_point(q, tot, T, r - d);
    __syncthreads();
    if (r >= d) {
      g1_add(acc, q, acc);
      put_point(tot, T, r, acc);
    }
    __syncthreads();
  }

  // 3. the run's exclusive prefixes from its offset
  if (r == 0)
    g1_set_identity(acc);
  else
    get_point(acc, tot, T, r - 1);
  for (int s = s0; s < s1; s++) {
    int64_t off = (int64_t)s * 24 * lanes + lane;
    store_limbs<12>(ox + off, lanes, acc.x);
    store_limbs<12>(oy + off, lanes, acc.y);
    store_limbs<12>(oz + off, lanes, acc.z);
    if (s + 1 < s1) {
      load_point(q, gx, gy, gz, off, lanes);
      g1_add(acc, acc, q);
    }
  }
}

// T threads a block (at most 128), m steps a run, T m >= steps; one block
// per lane
extern "C" int dt_ec_scan_excl(const void* gx, const void* gy, const void* gz,
                               void* ox, void* oy, void* oz, int steps,
                               int64_t lanes, int T, int m, void* stream) {
  if (lanes > 0 && steps > 0) {
    if (T < 1 || T > 128 || (int64_t)T * m < steps)
      return (int)cudaErrorInvalidValue;
    size_t smem = (size_t)36 * T * sizeof(uint32_t);
    ec_scan_excl_kernel<<<(unsigned)lanes, T, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)gx, (const uint32_t*)gy, (const uint32_t*)gz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, steps, lanes, m);
  }
  return (int)cudaGetLastError();
}
