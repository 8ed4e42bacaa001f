// Variants of K12 (dusk_plonk_torch/csrc/ec_scan_em.cu), of K11a's layout
// and of K10 (dusk_plonk_torch/csrc/ec_add_mixed.cu) for
// tools/kernel_variants/k12_variants.py, one library with one C entry each
// (the package's sources are compiled in, so its kernels are here too):
//   k12_serial     the element-major scan before the team design: one
//                  thread a lane, 64-thread blocks, 256 dependent
//                  mixed adds (the sequential order), each thread storing
//                  its 72-word rows itself;
//   k12_team2      the sequential order with each mixed add on a team of two
//                  threads (ec.cuh::g1_add_mixed_team<2>: chain 6 dependent
//                  multiplies against 11), rows stored by the team;
//   k12_team_staged  the package's team scan (rows staged in shared memory,
//                  written out contiguously) on a team of 2, 3 or 6;
//   k12_block      a block-parallel scan over the step axis: T threads a
//                  lane, each owning a run of m = ceil(cl / T) steps; the run
//                  totals by mixed adds, a Hillis-Steele scan of them by
//                  complete adds in shared memory, then each run's prefixes
//                  from its offset by mixed adds (a chain of 2m + log2 T
//                  adds for twice the work; other projective
//                  representatives than the sequential order).  Stored as
//                  K12's rows staged (mode 2) or unstaged (mode 1), or as
//                  K11a's three (cl, 24, lanes) limb planes (mode 0);
//   k10_loop       `reps` launches of K10 in one C call, so that a ~10 us
//                  launch is not held by ctypes: team 1 is the one-thread
//                  kernel before the team design, teams 2, 3 and 6 the
//                  package's kernel;
//   empty_loop     `reps` launches of an empty kernel on the same grid: the
//                  card's launch floor under K7, K8 and K10.
#include "../../dusk_plonk_torch/csrc/ec_add_mixed.cu"
#include "../../dusk_plonk_torch/csrc/ec_scan_em.cu"

__global__ void __launch_bounds__(128)
k12_serial_kernel(const uint32_t* __restrict__ g, uint32_t* __restrict__ out,
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
    uint32_t* row = out + ((int64_t)s * lanes + lane) * 72;
    store_limbs<12>(row, 1, acc.x);
    store_limbs<12>(row + 24, 1, acc.y);
    store_limbs<12>(row + 48, 1, acc.z);
  }
}

extern "C" int k12_serial(const void* g, void* out, int cl, int64_t lanes,
                          void* stream) {
  int64_t blocks = (lanes + 63) / 64;
  k12_serial_kernel<<<(unsigned)blocks, 64, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)g, (uint32_t*)out, cl, lanes);
  return (int)cudaGetLastError();
}

constexpr int TEAM2_THREADS = 64;
constexpr int TEAM2_STRIDE = TEAM2_THREADS / 2 * TEAM_SLOTS;

__global__ void __launch_bounds__(TEAM2_THREADS)
k12_team2_kernel(const uint32_t* __restrict__ g, uint32_t* __restrict__ out,
                 int cl, int64_t lanes) {
  __shared__ uint32_t scratch[12 * TEAM2_STRIDE];
  int team = threadIdx.x / 2, rank = threadIdx.x % 2;
  int64_t lane = (int64_t)blockIdx.x * (TEAM2_THREADS / 2) + team;
  bool live = lane < lanes;
  if (!live) lane = lanes - 1;       // a copy, stored by no thread
  uint32_t* s = scratch + team * TEAM_SLOTS;
  G1Proj acc;
  g1_set_identity(acc);
  for (int st = 0; st < cl; st++) {
    const uint32_t* src = g + (int64_t)st * 48 * lanes + lane;
    Fq x2, y2;
    load_limbs<12>(x2, src, lanes);
    load_limbs<12>(y2, src + 24 * lanes, lanes);
    g1_add_mixed_team<2>(acc, acc, x2, y2, rank, s, TEAM2_STRIDE);
    uint32_t* row = out + ((int64_t)st * lanes + lane) * 72;
    if (live && rank == 0) {
      store_limbs<12>(row, 1, acc.x);
      store_limbs<12>(row + 48, 1, acc.z);
    }
    if (live && rank == 1) store_limbs<12>(row + 24, 1, acc.y);
  }
}

extern "C" int k12_team2(const void* g, void* out, int cl, int64_t lanes,
                         void* stream) {
  int64_t per = TEAM2_THREADS / 2;
  int64_t blocks = (lanes + per - 1) / per;
  k12_team2_kernel<<<(unsigned)blocks, TEAM2_THREADS, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)g,
                                             (uint32_t*)out, cl, lanes);
  return (int)cudaGetLastError();
}

template <int MODE>
__global__ void __launch_bounds__(SCAN_THREADS, 6)
block_kernel(const uint32_t* __restrict__ g, uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int cl,
             int64_t lanes, int m, int levels) {
  // the run totals (36 words a thread), then the warps' staged rows
  __shared__ uint32_t smem[SCAN_THREADS * STAGE_WORDS];
  const int t = threadIdx.x;
  const int per = SCAN_THREADS >> levels;           // lanes a block
  const int r = t / per;                            // run
  const int64_t lane = (int64_t)blockIdx.x * per + (t - r * per);
  const int s0 = min(r * m, cl);
  const int s1 = lane < lanes ? min(s0 + m, cl) : s0;   // no lane: no steps
  G1Proj acc;
  g1_set_identity(acc);
  for (int s = s0; s < s1; s++) {                   // 1. the run's total
    const uint32_t* src = g + (int64_t)s * 48 * lanes + lane;
    Fq x2, y2;
    load_limbs<12>(x2, src, lanes);
    load_limbs<12>(y2, src + 24 * lanes, lanes);
    g1_add_mixed(acc, acc, x2, y2);
  }
  // 2. inclusive scan of the run totals; run r - d of the lane sits d * per
  //    slots below
  put_point(smem, SCAN_THREADS, t, acc);
  __syncthreads();
  for (int d = 1; d < (1 << levels); d <<= 1) {
    G1Proj q;
    if (r >= d) get_point(q, smem, SCAN_THREADS, t - d * per);
    __syncthreads();
    if (r >= d) {
      g1_add(acc, q, acc);
      put_point(smem, SCAN_THREADS, t, acc);
    }
    __syncthreads();
  }
  if (r == 0)
    g1_set_identity(acc);
  else
    get_point(acc, smem, SCAN_THREADS, t - per);
  __syncthreads();                                  // smem turns stage
  // 3. the run's prefixes from its offset, m steps on every thread of the
  //    warp (staged stores are the warp's together)
  uint32_t* stage = smem + (t / 32) * 32 * STAGE_WORDS;
  for (int j = 0; j < m; j++) {
    const int s = s0 + j;
    const bool live = s < s1;
    if (live) {
      const uint32_t* src = g + (int64_t)s * 48 * lanes + lane;
      Fq x2, y2;
      load_limbs<12>(x2, src, lanes);
      load_limbs<12>(y2, src + 24 * lanes, lanes);
      g1_add_mixed(acc, acc, x2, y2);
    }
    if (MODE == 2) {
      store_rows_staged(ox, stage, acc, live ? (int64_t)s * lanes + lane : -1,
                        t & 31);
    } else if (live && MODE == 1) {
      uint32_t* row = ox + ((int64_t)s * lanes + lane) * 72;
      store_limbs<12>(row, 1, acc.x);
      store_limbs<12>(row + 24, 1, acc.y);
      store_limbs<12>(row + 48, 1, acc.z);
    } else if (live) {
      int64_t off = (int64_t)s * 24 * lanes + lane;
      store_limbs<12>(ox + off, lanes, acc.x);
      store_limbs<12>(oy + off, lanes, acc.y);
      store_limbs<12>(oz + off, lanes, acc.z);
    }
  }
}

// T a power of two, 2 <= T <= SCAN_THREADS, T m >= cl; mode as above
extern "C" int k12_block(const void* g, void* ox, void* oy, void* oz, int cl,
                         int64_t lanes, int T, int m, int mode, void* stream) {
  if (T < 2 || T > SCAN_THREADS || (T & (T - 1)) || (int64_t)T * m < cl)
    return (int)cudaErrorInvalidValue;
  int levels = 0;
  while ((1 << levels) < T) levels++;
  int64_t blocks = (lanes + SCAN_THREADS / T - 1) / (SCAN_THREADS / T);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* gi = (const uint32_t*)g;
  uint32_t *x = (uint32_t*)ox, *y = (uint32_t*)oy, *z = (uint32_t*)oz;
  if (mode == 2)
    block_kernel<2><<<(unsigned)blocks, SCAN_THREADS, 0, st>>>(
        gi, x, y, z, cl, lanes, m, levels);
  else if (mode == 1)
    block_kernel<1><<<(unsigned)blocks, SCAN_THREADS, 0, st>>>(
        gi, x, y, z, cl, lanes, m, levels);
  else
    block_kernel<0><<<(unsigned)blocks, SCAN_THREADS, 0, st>>>(
        gi, x, y, z, cl, lanes, m, levels);
  return (int)cudaGetLastError();
}

extern "C" int k12_team_staged(const void* g, void* out, int cl,
                               int64_t lanes, int team, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (team) {
    case 2: launch_team<2>(g, out, cl, lanes, st); break;
    case 3: launch_team<3>(g, out, cl, lanes, st); break;
    case 6: launch_team<6>(g, out, cl, lanes, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K10 before the team design: one thread a lane, 128-thread blocks
__global__ void __launch_bounds__(128)
k10_serial_kernel(const uint32_t* __restrict__ px,
                  const uint32_t* __restrict__ py,
                  const uint32_t* __restrict__ pz,
                  const uint32_t* __restrict__ qx,
                  const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                  int64_t rows, int64_t n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  int64_t r = idx / n;
  int64_t off = r * 24 * n + (idx - r * n);
  G1Proj p;
  Fq x2, y2;
  load_point(p, px, py, pz, off, n);
  load_limbs<12>(x2, qx + off, n);
  load_limbs<12>(y2, qy + off, n);
  g1_add_mixed(p, p, x2, y2);
  store_limbs<12>(ox + off, n, p.x);
  store_limbs<12>(oy + off, n, p.y);
  store_limbs<12>(oz + off, n, p.z);
}

extern "C" int k10_loop(const void* px, const void* py, const void* pz,
                        const void* qx, const void* qy, void* ox, void* oy,
                        void* oz, int64_t rows, int64_t n, int team,
                        int reps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  for (int i = 0; i < reps; i++) {
    switch (team) {
      case 1:
        k10_serial_kernel<<<(unsigned)((rows * n + 127) / 128), 128, 0,
                            st>>>(
            (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
            (const uint32_t*)qx, (const uint32_t*)qy, (uint32_t*)ox,
            (uint32_t*)oy, (uint32_t*)oz, rows, n);
        break;
      case 2: launch<2>(px, py, pz, qx, qy, ox, oy, oz, rows, n, st); break;
      case 3: launch<3>(px, py, pz, qx, qy, ox, oy, oz, rows, n, st); break;
      case 6: launch<6>(px, py, pz, qx, qy, ox, oy, oz, rows, n, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

extern "C" int empty_loop(int64_t blocks, int threads, int reps,
                          void* stream) {
  for (int i = 0; i < reps; i++)
    empty_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
