// Variant of K7 (dusk_plonk_torch/csrc/ec_double_add.cu) for
// tools/kernel_variants/k7_variants.py: with INTERLEAVE, each doubling runs
// its four independent multiplies (y^2, yz, z^2, xy), then the next four,
// with their CIOS rows interleaved; THREADS sets the block width.
#include "../../dusk_plonk_torch/csrc/ec.cuh"

// K independent Montgomery products, their CIOS rows interleaved
template <int NW, int K>
__device__ __forceinline__ void mont_mul_x(uint32_t (&r)[K][NW],
                                           const uint32_t (&a)[K][NW],
                                           const uint32_t (&b)[K][NW]) {
  uint32_t p[NW];
  Modulus<NW>::words(p);
  uint32_t even[K][NW], odd[K][NW];
#pragma unroll
  for (int j = 0; j < K; j++) mont_row<NW, true>(even[j], odd[j], a[j], p, b[j][0]);
#pragma unroll
  for (int j = 0; j < K; j++) mont_row<NW, false>(odd[j], even[j], a[j], p, b[j][1]);
#pragma unroll
  for (int i = 2; i < NW; i += 2) {
#pragma unroll
    for (int j = 0; j < K; j++) mont_row<NW, false>(even[j], odd[j], a[j], p, b[j][i]);
#pragma unroll
    for (int j = 0; j < K; j++) mont_row<NW, false>(odd[j], even[j], a[j], p, b[j][i + 1]);
  }
#pragma unroll
  for (int j = 0; j < K; j++) {
    even[j][0] = add_cc(even[j][0], odd[j][1]);
#pragma unroll
    for (int w = 1; w < NW - 1; w++) even[j][w] = addc_cc(even[j][w], odd[j][w + 1]);
    even[j][NW - 1] = addc(even[j][NW - 1], 0);
    cond_sub_p<NW>(r[j], even[j], 0);
  }
}

__device__ __forceinline__ void cp(Fq& d, const Fq& s) {
#pragma unroll
  for (int i = 0; i < 12; i++) d[i] = s[i];
}

__device__ __forceinline__ void g1_dbl_x(G1Proj& r, const G1Proj& p) {
  uint32_t A[4][12], B[4][12], R[4][12];
  cp(A[0], p.y); cp(B[0], p.y);     // t0 = y^2
  cp(A[1], p.y); cp(B[1], p.z);     // t1 = y z
  cp(A[2], p.z); cp(B[2], p.z);     // t2 = z^2
  cp(A[3], p.x); cp(B[3], p.y);     // t3 = x y
  mont_mul_x<12, 4>(R, A, B);
  Fq t0, t1, t2, t3, z3, y3, u, v;
  cp(t0, R[0]); cp(t1, R[1]); cp(t2, R[2]); cp(t3, R[3]);
  fq_add(z3, t0, t0);
  fq_add(z3, z3, z3);
  fq_add(z3, z3, z3);
  fq_mul12(t2, t2);
  fq_add(y3, t0, t2);
  fq_add(u, t2, t2);
  fq_add(v, u, t2);
  fq_sub(t0, t0, v);
  cp(A[0], t2); cp(B[0], z3);       // x3 = t2 z3
  cp(A[1], t1); cp(B[1], z3);       // z3 = t1 z3
  cp(A[2], t0); cp(B[2], y3);       // y3 = t0 y3
  cp(A[3], t0); cp(B[3], t3);       // x3' = t0 t3
  mont_mul_x<12, 4>(R, A, B);
  fq_add(r.y, R[0], R[2]);
  fq_add(r.x, R[3], R[3]);
  cp(r.z, R[1]);
}

__global__ void __launch_bounds__(128)
k7_kernel(const uint32_t* __restrict__ ax, const uint32_t* __restrict__ ay,
          const uint32_t* __restrict__ az, const uint32_t* __restrict__ bx,
          const uint32_t* __restrict__ by, const uint32_t* __restrict__ bz,
          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
          uint32_t* __restrict__ oz, int k, int64_t lanes) {
  int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  G1Proj acc;
  load_limbs<12>(acc.x, ax + lane, lanes);
  load_limbs<12>(acc.y, ay + lane, lanes);
  load_limbs<12>(acc.z, az + lane, lanes);
#ifdef INTERLEAVE
  for (int i = 0; i < k; i++) g1_dbl_x(acc, acc);
#else
  for (int i = 0; i < k; i++) g1_dbl(acc, acc);
#endif
  G1Proj q;
  load_limbs<12>(q.x, bx + lane, lanes);
  load_limbs<12>(q.y, by + lane, lanes);
  load_limbs<12>(q.z, bz + lane, lanes);
  g1_add(acc, acc, q);
  store_limbs<12>(ox + lane, lanes, acc.x);
  store_limbs<12>(oy + lane, lanes, acc.y);
  store_limbs<12>(oz + lane, lanes, acc.z);
}

extern "C" int dt_ec_double_add(const void* ax, const void* ay, const void* az,
                                const void* bx, const void* by, const void* bz,
                                void* ox, void* oy, void* oz, int k,
                                int64_t lanes, void* stream) {
  int threads = THREADS;
  int64_t blocks = (lanes + threads - 1) / threads;
  k7_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ax, (const uint32_t*)ay, (const uint32_t*)az,
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, k, lanes);
  return (int)cudaGetLastError();
}
