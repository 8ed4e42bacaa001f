// K12: per-lane inclusive prefix scan of complete mixed G1 additions,
// element-major output.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::
// ec_scan_mixed14_em (_ec_scan_mixed14_em_kernel), the chunk scan of the
// Pippenger MSM with element-major output, routed by config.ec_scan_em:
// the bucket phase then reads each prefix point as 72 contiguous words.
// The JAX 14-bit kernel returns the points projectively scaled by 2^8;
// this returns the 16-bit engine's own triples (the same points).
//
// Input g is (cl, 48, lanes): for step s, rows 0..23 hold the affine x and
// rows 24..47 the affine y of the point added on each lane (never the
// identity).  Output (cl, lanes, 72): row (s, lane) is the sum of that
// lane's points of steps 0..s, x, y, z as 24 limbs each.
//
// Bound on the H100: at the alt proof's 5,140-20,560 lanes, the latency of
// the dependent chain of mixed adds (11 Fq multiplies each), not the
// card's throughput: one thread a lane runs 256 in a row with 40-160
// threads an SM.  So the chain is made short in time: a team of N = 3 or
// 6 threads a lane (ec_scan_em_team_kernel) runs each mixed add's
// independent multiplies side by side (ec.cuh::g1_add_mixed_team: a chain
// of 4 or 2 dependent multiplies a step against 11), in the sequential
// order.  32 / N lanes a warp, consecutive.  Past the widths where the
// card's issue rate binds, one thread a lane (ec_scan_em_kernel) issues
// fewer instructions a lane and wins; ops/kernels.py::_scan_team picks N
// by the lane count.  Either way the output is the sequential scan's (the
// JAX kernel's order), limb for limb.
//
// Stores: a thread's row is 72 contiguous words, so a warp storing one
// word of its 32 rows touches 32 places 288 bytes apart; on the H100 that
// made the element-major scan 1.3-2.4x slower than the same scan into
// limb planes.  So each step's rows go out through shared memory:
// consecutive threads write consecutive words of the warp's rows, which
// are one contiguous span (consecutive lanes).
// __launch_bounds__(SCAN_THREADS, 6) on the one-thread kernel: the
// register file is split among an SM's four schedulers, so twelve warps
// (six blocks) an SM hold at most 168 registers a thread.

#include "ec.cuh"

static constexpr int SCAN_THREADS = 64;
static constexpr int STAGE_WORDS = 73;   // a staged row and one pad word:
                                         // a warp's 32 rows start in 32
                                         // different banks

// The 32 rows of one step of the calling warp, through shared memory:
// thread w puts acc in stage row w, then the warp writes every row's
// words with consecutive threads on consecutive words.  dst is the row's
// index s * lanes + lane in `out`, or -1 for no row.  All 32 threads of
// the warp call it together.
__device__ __forceinline__ void store_rows_staged(uint32_t* __restrict__ out,
                                                  uint32_t* stage,
                                                  const G1Proj& acc,
                                                  int64_t dst, int w) {
  uint32_t* mine = stage + w * STAGE_WORDS;
  store_limbs<12>(mine, 1, acc.x);
  store_limbs<12>(mine + 24, 1, acc.y);
  store_limbs<12>(mine + 48, 1, acc.z);
  __syncwarp();
  for (int k = w; k < 32 * 72; k += 32) {
    int row = k / 72;
    int col = k - row * 72;
    int64_t d = __shfl_sync(0xffffffffu, dst, row);
    if (d >= 0) out[d * 72 + col] = stage[row * STAGE_WORDS + col];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(SCAN_THREADS, 6)
ec_scan_em_kernel(const uint32_t* __restrict__ g, uint32_t* __restrict__ out,
                  int cl, int64_t lanes) {
  __shared__ uint32_t stage[SCAN_THREADS * STAGE_WORDS];
  const int t = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * SCAN_THREADS + t;
  const bool live = lane < lanes;
  uint32_t* st = stage + (t / 32) * 32 * STAGE_WORDS;
  G1Proj acc;
  g1_set_identity(acc);
  // every thread of the warp runs every step: the stores are the warp's
  // together
  for (int s = 0; s < cl; s++) {
    if (live) {
      const uint32_t* src = g + (int64_t)s * 48 * lanes + lane;
      Fq x2, y2;
      load_limbs<12>(x2, src, lanes);
      load_limbs<12>(y2, src + 24 * lanes, lanes);
      g1_add_mixed(acc, acc, x2, y2);
    }
    store_rows_staged(out, st, acc, live ? (int64_t)s * lanes + lane : -1,
                      t & 31);
  }
}

// The sequential scan with each mixed add on a team of N threads of one
// warp, 32 / N lanes a warp (the last 32 mod N threads a padding team
// that runs a copy and stores nothing), SCAN_THREADS / 32 warps a block.
template <int N>
__global__ void __launch_bounds__(SCAN_THREADS)
ec_scan_em_team_kernel(const uint32_t* __restrict__ g,
                       uint32_t* __restrict__ out, int cl, int64_t lanes) {
  constexpr int WARPS = SCAN_THREADS / 32;
  constexpr int LANES = 32 / N;                     // lanes a warp
  constexpr int TEAMS = (32 + N - 1) / N;           // teams a warp, pads too
  constexpr int STRIDE = WARPS * TEAMS * TEAM_SLOTS;
  __shared__ uint32_t scratch[12 * STRIDE];
  __shared__ uint32_t stage[WARPS * LANES * STAGE_WORDS];
  const int wi = threadIdx.x / 32, w = threadIdx.x % 32;
  const int team = w / N, rank = w - team * N;
  const int64_t first = ((int64_t)blockIdx.x * WARPS + wi) * LANES;
  const int64_t lane = first + team < lanes ? first + team : lanes - 1;
  const int64_t left = lanes - first;               // the warp's live rows
  const int rows = left <= 0 ? 0 : (left < LANES ? (int)left : LANES);
  uint32_t* slots = scratch + (wi * TEAMS + team) * TEAM_SLOTS;
  uint32_t* st = stage + wi * LANES * STAGE_WORDS;
  G1Proj acc;
  g1_set_identity(acc);
  for (int s = 0; s < cl; s++) {
    const uint32_t* src = g + (int64_t)s * 48 * lanes + lane;
    Fq x2, y2;
    load_limbs<12>(x2, src, lanes);
    load_limbs<12>(y2, src + 24 * lanes, lanes);
    g1_add_mixed_team<N>(acc, acc, x2, y2, rank, slots, STRIDE);
    if (team < LANES) {                             // rank c % N: coordinate c
      uint32_t* row = st + team * STAGE_WORDS;
      if (rank == 0) store_limbs<12>(row, 1, acc.x);
      if (rank == 1 % N) store_limbs<12>(row + 24, 1, acc.y);
      if (rank == 2 % N) store_limbs<12>(row + 48, 1, acc.z);
    }
    __syncwarp();
    uint32_t* dst = out + ((int64_t)s * lanes + first) * 72;
    for (int k = w; k < rows * 72; k += 32) {
      int row = k / 72;
      dst[k] = st[row * STAGE_WORDS + (k - row * 72)];
    }
    __syncwarp();
  }
}

template <int N>
static void launch_team(const void* g, void* out, int cl, int64_t lanes,
                        cudaStream_t stream) {
  int64_t per = SCAN_THREADS / 32 * (32 / N);       // lanes a block
  ec_scan_em_team_kernel<N><<<(unsigned)((lanes + per - 1) / per),
                              SCAN_THREADS, 0, stream>>>(
      (const uint32_t*)g, (uint32_t*)out, cl, lanes);
}

// team: threads a lane, 1 (ec_scan_em_kernel), 3 or 6 (the team scan)
extern "C" int dt_ec_scan_mixed_em(const void* g, void* out, int cl,
                                   int64_t lanes, int team, void* stream) {
  if (lanes > 0 && cl > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (team) {
      case 1:
        ec_scan_em_kernel<<<(unsigned)((lanes + SCAN_THREADS - 1) /
                                       SCAN_THREADS),
                            SCAN_THREADS, 0, st>>>((const uint32_t*)g,
                                                   (uint32_t*)out, cl, lanes);
        break;
      case 3:
        launch_team<3>(g, out, cl, lanes, st);
        break;
      case 6:
        launch_team<6>(g, out, cl, lanes, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
