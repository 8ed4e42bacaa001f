// Variants of K8 (dusk_plonk_torch/csrc/ec_combine.cu) for
// tools/kernel_variants/k9_variants.py, all behind K8's C entry
// dt_ec_combine:
//   -DSERIAL  the kernel before the team design: one thread a lane, from
//             the identity, each doubling the complete add acc + acc;
//   -DDBL1    one thread a lane, from T_0, g1_dbl and g1_add: the
//             package's order without the team;
//   -DSHARED  the package's team of six threads a lane, but the
//             doubling's adds between its levels run on rank 0 alone,
//             which hands the second level's operands to the others
//             through shared memory (the package runs them on every
//             thread of the team).
// k9_variants.py times the package's own K8 beside these.
#include "../../dusk_plonk_torch/csrc/ec.cuh"

#if defined(SERIAL) || defined(DBL1)

__global__ void __launch_bounds__(32)
k8_kernel(const uint32_t* __restrict__ gx, const uint32_t* __restrict__ gy,
          const uint32_t* __restrict__ gz, uint32_t* __restrict__ ox,
          uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int windows,
          int c, int64_t lanes) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  G1Proj acc, t;
#if defined(SERIAL)
  g1_set_identity(acc);
  for (int w = 0; w < windows; w++) {
    for (int i = 0; i < c; i++) g1_add(acc, acc, acc);
    load_point(t, gx, gy, gz, (int64_t)w * 24 * lanes + lane, lanes);
    g1_add(acc, acc, t);
  }
#else
  load_point(acc, gx, gy, gz, lane, lanes);
  for (int w = 1; w < windows; w++) {
    for (int i = 0; i < c; i++) g1_dbl(acc, acc);
    load_point(t, gx, gy, gz, (int64_t)w * 24 * lanes + lane, lanes);
    g1_add(acc, acc, t);
  }
#endif
  store_limbs<12>(ox + lane, lanes, acc.x);
  store_limbs<12>(oy + lane, lanes, acc.y);
  store_limbs<12>(oz + lane, lanes, acc.z);
}

static int64_t k8_blocks(int64_t lanes) { return (lanes + 31) / 32; }

#elif defined(SHARED)

constexpr int KT = 6, LPW = 32 / KT, TPW = (32 + KT - 1) / KT;
constexpr int STRIDE = TPW * TEAM_SLOTS;

// g1_dbl_team<6> with the adds between the levels on rank 0 alone: it
// puts the second level's six distinct operands in slots 6-11, and each
// thread reads its pair from there (the products go to slots 0-3 again
// after a second __syncwarp)
__device__ __forceinline__ void g1_dbl_shared(G1Proj& r, const G1Proj& p,
                                              int rank, uint32_t* s,
                                              int stride) {
  int j = rank < 4 ? rank : 3;
  Fq a, b, t;
  fq_sel(a, j == 2, p.z, p.y);
  fq_sel(a, j >= 3, p.x, a);
  fq_sel(b, j == 1 || j == 2, p.z, p.y);
  fq_mul(t, a, b);
  if (rank < 4) put_slot(s, stride, j, t);
  __syncwarp();
  if (rank == 0) {
    Fq t0, t2, z3, y3, u;
    get_slot(t0, s, stride, 0);
    get_slot(t2, s, stride, 2);
    fq_add(z3, t0, t0);
    fq_add(z3, z3, z3);
    fq_add(z3, z3, z3);
    fq_mul12(t2, t2);
    fq_add(y3, t0, t2);
    fq_add(u, t2, t2);
    fq_add(u, u, t2);
    fq_sub(t0, t0, u);
    put_slot(s, stride, 6, t2);      // 6: 12 z^2   7: 8 y^2
    put_slot(s, stride, 7, z3);      // 8: y^2 - 36 z^2   9: y^2 + 12 z^2
    put_slot(s, stride, 8, t0);      // (slot 1: y z, slot 3: x y)
    put_slot(s, stride, 9, y3);
  }
  __syncwarp();
  // a: 6, 1, 8, 8; b: 7, 7, 9, 3
  int ka = j == 0 ? 6 : (j == 1 ? 1 : 8);
  int kb = j <= 1 ? 7 : (j == 2 ? 9 : 3);
  get_slot(a, s, stride, ka);
  get_slot(b, s, stride, kb);
  fq_mul(t, a, b);
  __syncwarp();
  if (rank < 4) put_slot(s, stride, j, t);
  __syncwarp();
  Fq x3, y3, xy;
  get_slot(x3, s, stride, 0);
  get_slot(r.z, s, stride, 1);
  get_slot(y3, s, stride, 2);
  get_slot(xy, s, stride, 3);
  fq_add(r.y, x3, y3);
  fq_add(r.x, xy, xy);
  __syncwarp();
}

__global__ void __launch_bounds__(32)
k8_kernel(const uint32_t* __restrict__ gx, const uint32_t* __restrict__ gy,
          const uint32_t* __restrict__ gz, uint32_t* __restrict__ ox,
          uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int windows,
          int c, int64_t lanes) {
  __shared__ uint32_t scratch[12 * STRIDE];
  int team = threadIdx.x / KT, rank = threadIdx.x - team * KT;
  int64_t lane = (int64_t)blockIdx.x * LPW + team;
  bool owner = team < LPW && lane < lanes && rank == 0;
  if (lane >= lanes) lane = lanes - 1;
  uint32_t* s = scratch + team * TEAM_SLOTS;
  G1Proj acc, t;
  load_point(acc, gx, gy, gz, lane, lanes);
  for (int w = 1; w < windows; w++) {
    for (int i = 0; i < c; i++) g1_dbl_shared(acc, acc, rank, s, STRIDE);
    load_point(t, gx, gy, gz, (int64_t)w * 24 * lanes + lane, lanes);
    g1_add_team<KT>(acc, acc, t, rank, s, STRIDE);
  }
  if (owner) {
    store_limbs<12>(ox + lane, lanes, acc.x);
    store_limbs<12>(oy + lane, lanes, acc.y);
    store_limbs<12>(oz + lane, lanes, acc.z);
  }
}

static int64_t k8_blocks(int64_t lanes) { return (lanes + LPW - 1) / LPW; }

#else
#error "define SERIAL, DBL1 or SHARED"
#endif

extern "C" int dt_ec_combine(const void* gx, const void* gy, const void* gz,
                             void* ox, void* oy, void* oz, int windows, int c,
                             int64_t lanes, void* stream) {
  if (lanes > 0) {
    k8_kernel<<<(unsigned)k8_blocks(lanes), 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)gx, (const uint32_t*)gy, (const uint32_t*)gz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, windows, c, lanes);
  }
  return (int)cudaGetLastError();
}
