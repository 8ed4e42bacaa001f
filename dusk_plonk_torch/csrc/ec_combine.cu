// K8: the Pippenger window combine, sum_w 2^(c (W-1-w)) T_w, MSB window
// first.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::ec_combine14
// (_ec_combine14_kernel), which ops/msm.py::MsmPlan.msm_device runs after
// the window totals.  The TPU kernel starts from the identity and doubles
// with the complete addition acc + acc; here acc starts at T_0, and for
// each further window takes c doublings (RCB15 algorithm 9) and one
// complete add.  The output is the TPU kernel's group element in another
// projective representative; the plain version
// (ops/kernels.py::ec_combine_plain) runs the same order, so it agrees limb
// for limb.
//
// Input: three (W, 24, lanes) planes of window totals (W >= 1), MSB window
// first; output: three (24, lanes) planes.
//
// Bound on the H100: the serial chain, c (W - 1) doublings and W - 1 adds
// (247 and 19 for W = 20, c = 13) on one MSM; msm_device combines one lane
// and moves W * 72 words, so neither HBM nor the card's ALU is near its
// limit and the chain's latency is the time.  Design: each lane is a team
// of six threads of one warp (ec.cuh::g1_dbl_team, g1_add_team): each
// level of a formula's independent multiplies runs one multiply to a
// thread, so a doubling or an add costs two dependent multiplies, not 8 or
// 12: 2 (c + 1)(W - 1) = 532 on the chain against the 3,360 of 280
// complete adds from the identity.  A warp holds five lanes (30 threads);
// the last two threads run a copy and store nothing.

#include "ec.cuh"

constexpr int COMBINE_TEAM = 6;
constexpr int COMBINE_LANES = 32 / COMBINE_TEAM;           // lanes a warp
constexpr int COMBINE_TEAMS = (32 + COMBINE_TEAM - 1) / COMBINE_TEAM;
constexpr int COMBINE_STRIDE = COMBINE_TEAMS * TEAM_SLOTS;  // slots a warp

__global__ void __launch_bounds__(32)
ec_combine_kernel(const uint32_t* __restrict__ gx,
                  const uint32_t* __restrict__ gy,
                  const uint32_t* __restrict__ gz, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                  int windows, int c, int64_t lanes) {
  __shared__ uint32_t scratch[12 * COMBINE_STRIDE];
  int team = threadIdx.x / COMBINE_TEAM;
  int rank = threadIdx.x - team * COMBINE_TEAM;
  int64_t lane = (int64_t)blockIdx.x * COMBINE_LANES + team;
  bool owner = team < COMBINE_LANES && lane < lanes && rank == 0;
  if (lane >= lanes) lane = lanes - 1;     // a copy, stored by no thread
  uint32_t* s = scratch + team * TEAM_SLOTS;
  G1Proj acc, t;
  load_point(acc, gx, gy, gz, lane, lanes);
  for (int w = 1; w < windows; w++) {
    for (int i = 0; i < c; i++)
      g1_dbl_team<COMBINE_TEAM>(acc, acc, rank, s, COMBINE_STRIDE);
    load_point(t, gx, gy, gz, (int64_t)w * 24 * lanes + lane, lanes);
    g1_add_team<COMBINE_TEAM>(acc, acc, t, rank, s, COMBINE_STRIDE);
  }
  if (owner) {
    store_limbs<12>(ox + lane, lanes, acc.x);
    store_limbs<12>(oy + lane, lanes, acc.y);
    store_limbs<12>(oz + lane, lanes, acc.z);
  }
}

extern "C" int dt_ec_combine(const void* gx, const void* gy, const void* gz,
                             void* ox, void* oy, void* oz, int windows, int c,
                             int64_t lanes, void* stream) {
  if (lanes > 0) {
    int64_t blocks = (lanes + COMBINE_LANES - 1) / COMBINE_LANES;
    ec_combine_kernel<<<(unsigned)blocks, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)gx, (const uint32_t*)gy, (const uint32_t*)gz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, windows, c, lanes);
  }
  return (int)cudaGetLastError();
}
