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
// (24, lanes) planes, the sum g_0 + g_1 + ... + g_{steps-1} of each lane.
//
// Bound on the H100: the dependent chain of adds.  At the MSM's shapes
// (level 1: 64 steps on 1,280 lanes a commit; level 2: 64 steps on 20) one
// thread per lane would run 64 dependent adds on a few warps of the 132
// SMs.  Design: a block-parallel tree sum.  Each lane gets T threads, each
// owning a run of m consecutive steps; (T, m) = ops/kernels.py::
// _sum_block(steps, lanes): T is the largest power of two with which the
// launch fits one wave of two 128-thread blocks an SM, at most 64 and at
// most `steps`, and m = ceil(steps / T).  (Filling a second wave to
// shorten the chain was slower on the H100: 0.36 against 0.33 ms at 5,120
// lanes.)  A block of 128 threads holds 128 / T lanes, lanes contiguous
// within a run, so neighbouring threads read neighbouring lanes of a limb
// row.
//   1. thread (r, lane) sums its run [r m, min((r + 1) m, steps)) from the
//      identity in registers (steps past `steps` are skipped);
//   2. a tree over the T run totals in shared memory: at d = 1, 2, ..,
//      T/2, v_r <- v_r + v_{r+d} for r = 0 mod 2d (v_{r+d} is final after
//      level d/2, so it is written once, just before the level reads it);
//   3. thread (0, lane) stores v_0.
// Both phases run through one inlined g1_add in one loop, so the kernel
// keeps one add's registers.  The dependent depth is m + log2 T adds
// instead of `steps`: 18 at 5,120 lanes (T = 4, m = 16), 8 at 1,280 (T =
// 16, m = 4), 7 at 80 (T = 64, m = 1).  The sum is the sequential order's
// group element in another projective representative;
// ops/kernels.py::ec_sum_steps_plain with block = (T, m) repeats this
// order add for add.

#include "ec.cuh"

static constexpr int SUM_THREADS = 128;

__global__ void __launch_bounds__(SUM_THREADS)
ec_sum_steps_kernel(const uint32_t* __restrict__ gx,
                    const uint32_t* __restrict__ gy,
                    const uint32_t* __restrict__ gz, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int steps, int64_t lanes, int m, int levels) {
  __shared__ uint32_t tot[36 * SUM_THREADS];        // one slot a thread
  const int t = threadIdx.x;
  const int per = SUM_THREADS >> levels;            // lanes a block
  const int r = t / per;                            // run
  const int64_t lane = (int64_t)blockIdx.x * per + (t - r * per);
  const bool live = lane < lanes;
  G1Proj acc, q;
  g1_set_identity(acc);
  for (int i = 0; i < m + levels; i++) {
    bool add;
    if (i < m) {                                    // 1. the run
      const int s = r * m + i;
      add = live && s < steps;
      if (add) load_point(q, gx, gy, gz, (int64_t)s * 24 * lanes + lane, lanes);
    } else {                                        // 2. a tree level
      const int d = 1 << (i - m);
      if ((r & (2 * d - 1)) == d) put_point(tot, SUM_THREADS, t, acc);
      __syncthreads();
      add = live && (r & (2 * d - 1)) == 0;
      if (add) get_point(q, tot, SUM_THREADS, t + d * per);
    }
    if (add) g1_add(acc, acc, q);
  }
  if (live && r == 0) {                             // 3.
    store_limbs<12>(ox + lane, lanes, acc.x);
    store_limbs<12>(oy + lane, lanes, acc.y);
    store_limbs<12>(oz + lane, lanes, acc.z);
  }
}

// T threads a lane (a power of two, at most 64), m steps a run, T m >=
// steps
extern "C" int dt_ec_sum_steps(const void* gx, const void* gy, const void* gz,
                               void* ox, void* oy, void* oz, int steps,
                               int64_t lanes, int T, int m, void* stream) {
  if (lanes > 0) {
    if (T < 1 || T > 64 || (T & (T - 1)) != 0 || (int64_t)T * m < steps)
      return (int)cudaErrorInvalidValue;
    int levels = 0;
    while ((1 << levels) < T) levels++;
    int per = SUM_THREADS / T;
    int64_t blocks = (lanes + per - 1) / per;
    ec_sum_steps_kernel<<<(unsigned)blocks, SUM_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)gx, (const uint32_t*)gy, (const uint32_t*)gz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, steps, lanes, m, levels);
  }
  return (int)cudaGetLastError();
}
