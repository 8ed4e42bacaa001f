// Variants of K9 (dusk_plonk_torch/csrc/ec_add.cu) for
// tools/kernel_variants/k9_variants.py, all behind K9's C entry dt_ec_add:
//   (default)     the package's kernel: one thread a lane, 128-thread
//                 blocks, __launch_bounds__(THREADS, MINB);
//   -DMINB=3 / 4  the same kernel held to 3 or 4 resident blocks an SM
//                 (ptxas caps the registers at 170 / 128 and spills);
//   -DTEAM=T      a team of T threads a lane (ec.cuh::g1_add_team): each
//                 level's six multiplies one to a thread (in 6 / T rounds);
//   -DPAIRS       one thread a lane that runs each level's six multiplies
//                 as three pairs with their CIOS rows interleaved;
//   -DLEAN        one thread a lane on g1_add's steps reordered so that
//                 each operand dies as early as it can (fewer registers
//                 live at once; the same canonical values), with MINB.
// THREADS sets the block width (default 128).
#include "../../dusk_plonk_torch/csrc/ec.cuh"

#ifndef THREADS
#define THREADS 128
#endif
#ifndef MINB
#define MINB 1
#endif

#if defined(TEAM)

constexpr int LPW = 32 / TEAM;                      // lanes a warp
constexpr int TPW = (32 + TEAM - 1) / TEAM;         // teams a warp, pads too
constexpr int STRIDE = (THREADS / 32) * TPW * TEAM_SLOTS;

__global__ void __launch_bounds__(THREADS, MINB)
k9_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
          const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
          const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
          uint32_t* __restrict__ oz, int64_t rows, int64_t n) {
  __shared__ uint32_t scratch[12 * STRIDE];
  int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  int team = l / TEAM, rank = l - team * TEAM;
  int64_t total = rows * n;
  int64_t idx = ((int64_t)blockIdx.x * (THREADS / 32) + warp) * LPW + team;
  bool owner = team < LPW && idx < total;
  if (idx >= total) idx = total - 1;
  int64_t r = idx / n;
  int64_t off = r * 24 * n + (idx - r * n);
  G1Proj p, q;
  load_point(p, px, py, pz, off, n);
  load_point(q, qx, qy, qz, off, n);
  g1_add_team<TEAM>(p, p, q, rank, scratch + (warp * TPW + team) * TEAM_SLOTS,
                    STRIDE);
  if (owner && rank < 3) {            // rank k stores coordinate k
    Fq v;
    fq_sel(v, rank == 1, p.y, p.x);
    fq_sel(v, rank == 2, p.z, v);
    uint32_t* o = rank == 0 ? ox : (rank == 1 ? oy : oz);
    store_limbs<12>(o + off, n, v);
  }
}

static int64_t k9_blocks(int64_t total) {
  int64_t lanes_per_block = (THREADS / 32) * LPW;
  return (total + lanes_per_block - 1) / lanes_per_block;
}

#else

#if defined(PAIRS)
// K independent Montgomery products, their CIOS rows interleaved
template <int NW, int K>
__device__ __forceinline__ void mont_mul_x(uint32_t (&r)[K][NW],
                                           const uint32_t (&a)[K][NW],
                                           const uint32_t (&b)[K][NW]) {
  uint32_t p[NW];
  Modulus<NW>::words(p);
  uint32_t even[K][NW], odd[K][NW];
#pragma unroll
  for (int j = 0; j < K; j++)
    mont_row<NW, true>(even[j], odd[j], a[j], p, b[j][0]);
#pragma unroll
  for (int j = 0; j < K; j++)
    mont_row<NW, false>(odd[j], even[j], a[j], p, b[j][1]);
#pragma unroll
  for (int i = 2; i < NW; i += 2) {
#pragma unroll
    for (int j = 0; j < K; j++)
      mont_row<NW, false>(even[j], odd[j], a[j], p, b[j][i]);
#pragma unroll
    for (int j = 0; j < K; j++)
      mont_row<NW, false>(odd[j], even[j], a[j], p, b[j][i + 1]);
  }
#pragma unroll
  for (int j = 0; j < K; j++) {
    even[j][0] = add_cc(even[j][0], odd[j][1]);
#pragma unroll
    for (int w = 1; w < NW - 1; w++)
      even[j][w] = addc_cc(even[j][w], odd[j][w + 1]);
    even[j][NW - 1] = addc(even[j][NW - 1], 0);
    cond_sub_p<NW>(r[j], even[j], 0);
  }
}

__device__ __forceinline__ void cp(Fq& d, const Fq& s) {
#pragma unroll
  for (int i = 0; i < 12; i++) d[i] = s[i];
}

// r = a0 b0, s = a1 b1, interleaved
__device__ __forceinline__ void fq_mul2(Fq& r, const Fq& a0, const Fq& b0,
                                        Fq& s, const Fq& a1, const Fq& b1) {
  uint32_t A[2][12], B[2][12], R[2][12];
  cp(A[0], a0); cp(B[0], b0); cp(A[1], a1); cp(B[1], b1);
  mont_mul_x<12, 2>(R, A, B);
  cp(r, R[0]);
  cp(s, R[1]);
}

// g1_add with each level's multiplies two at a time
__device__ __forceinline__ void g1_add_pairs(G1Proj& r, const G1Proj& p,
                                             const G1Proj& q) {
  Fq t0, t1, t2, t3, t4, x3, y3, z3, u, v, u2, v2;
  fq_mul2(t0, p.x, q.x, t1, p.y, q.y);
  fq_add(u, p.x, p.y);
  fq_add(v, q.x, q.y);
  fq_mul2(t2, p.z, q.z, t3, u, v);
  fq_add(u, p.y, p.z);
  fq_add(v, q.y, q.z);
  fq_add(u2, p.x, p.z);
  fq_add(v2, q.x, q.z);
  fq_mul2(t4, u, v, x3, u2, v2);
  fq_add(u, t0, t1);
  fq_sub(t3, t3, u);
  fq_add(u, t1, t2);
  fq_sub(t4, t4, u);
  fq_add(u, t0, t2);
  fq_sub(y3, x3, u);
  fq_add(x3, t0, t0);
  fq_add(t0, x3, t0);
  fq_mul12(t2, t2);
  fq_add(z3, t1, t2);
  fq_sub(t1, t1, t2);
  fq_mul12(y3, y3);
  Fq m0, m1;
  fq_mul2(m0, t4, y3, m1, t3, t1);
  fq_sub(r.x, m1, m0);
  fq_mul2(m0, y3, t0, m1, t1, z3);
  fq_add(r.y, m1, m0);
  fq_mul2(m0, t0, t3, m1, z3, t4);
  fq_add(r.z, m1, m0);
}
#endif

#if defined(LEAN)
// g1_add's values in an order that ends each operand's life early: the
// products that read x1, x2 first, then y, then z; each output coordinate
// as soon as its two products are done.  r may alias p or q.
__device__ __forceinline__ void g1_add_lean(G1Proj& r, const G1Proj& p,
                                            const G1Proj& q) {
  Fq t0, t1, t2, t3, t4, y3, z3, u, v;
  fq_mul(t0, p.x, q.x);
  fq_add(u, p.x, p.z);
  fq_add(v, q.x, q.z);
  fq_mul(y3, u, v);                // (x1 + z1)(x2 + z2)
  fq_add(u, p.x, p.y);
  fq_add(v, q.x, q.y);
  fq_mul(t3, u, v);                // x1, x2 dead
  fq_mul(t1, p.y, q.y);
  fq_add(u, p.y, p.z);
  fq_add(v, q.y, q.z);
  fq_mul(t4, u, v);                // y1, y2 dead
  fq_mul(t2, p.z, q.z);            // p, q dead
  fq_add(u, t0, t1);
  fq_sub(t3, t3, u);               // x1y2 + x2y1
  fq_add(u, t1, t2);
  fq_sub(t4, t4, u);               // y1z2 + y2z1
  fq_add(u, t0, t2);
  fq_sub(y3, y3, u);               // x1z2 + x2z1
  fq_add(u, t0, t0);
  fq_add(t0, u, t0);               // 3 x1x2
  fq_mul12(t2, t2);                // b3 z1z2
  fq_add(z3, t1, t2);
  fq_sub(t1, t1, t2);
  fq_mul12(y3, y3);                // b3 (x1z2 + x2z1)
  fq_mul(u, t4, y3);
  fq_mul(v, t3, t1);
  fq_sub(r.x, v, u);
  fq_mul(u, y3, t0);
  fq_mul(v, t1, z3);
  fq_add(r.y, v, u);
  fq_mul(u, t0, t3);
  fq_mul(v, z3, t4);
  fq_add(r.z, v, u);
}
#endif

__global__ void __launch_bounds__(THREADS, MINB)
k9_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
          const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
          const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
          uint32_t* __restrict__ oz, int64_t rows, int64_t n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  int64_t r = idx / n;
  int64_t off = r * 24 * n + (idx - r * n);
  G1Proj p, q;
  load_point(p, px, py, pz, off, n);
  load_point(q, qx, qy, qz, off, n);
#if defined(PAIRS)
  g1_add_pairs(p, p, q);
#elif defined(LEAN)
  g1_add_lean(p, p, q);
#else
  g1_add(p, p, q);
#endif
  store_limbs<12>(ox + off, n, p.x);
  store_limbs<12>(oy + off, n, p.y);
  store_limbs<12>(oz + off, n, p.z);
}

static int64_t k9_blocks(int64_t total) {
  return (total + THREADS - 1) / THREADS;
}

#endif

extern "C" int dt_ec_add(const void* px, const void* py, const void* pz,
                         const void* qx, const void* qy, const void* qz,
                         void* ox, void* oy, void* oz, int64_t rows,
                         int64_t n, void* stream) {
  int64_t total = rows * n;
  if (total > 0) {
    k9_kernel<<<(unsigned)k9_blocks(total), THREADS, 0,
                (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
        (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)qz,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, rows, n);
  }
  return (int)cudaGetLastError();
}
