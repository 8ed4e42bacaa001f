// K2: one radix-2 decimation-in-time butterfly stage over Fr limb planes.
//
// Replaces the TPU kernels of dusk_plonk_tpu/ops/pallas_field.py::ntt_ladder:
// _ntt_local_kernel (every stage with half < tile, on one VMEM tile) and
// _ntt_global_kernel (one stage with half >= tile over paired blocks).
// Here every stage is one launch of the same kernel; the caller
// (ops/kernels.py::ntt_ladder) runs stages s = 0 .. k-1 on bit-reversed
// input, ping-ponging two buffers.
//
// Stage s, half = 2^s: the pair (i0, i0 + half) with j = i0 mod half
// becomes (u + w v, u - w v), u = x[i0], v = x[i0 + half],
// w = tw[j << (k-1-s)], where tw holds the n/2 powers of the stage root in
// Montgomery form (dft: w_n, idft: w_n^-1 -- direction lives in the
// values).  This is ops/ntt.py::NttPlan._transform's stage (ntt.py:185-206).
//
// Bound on the H100: integer ALU (one Montgomery multiply and two modular
// adds per butterfly against 192 bytes of traffic), plus k passes over the
// array at large n.  Design: one thread per butterfly, operands in
// registers; neighbouring threads take neighbouring j, so each limb-plane
// read is coalesced once half >= 32.  A shared-memory kernel that runs
// several stages per pass is later work.

#include "field.cuh"

__global__ void __launch_bounds__(256)
ntt_stage_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                 const uint32_t* __restrict__ tw, int64_t batch, int k,
                 int s) {
  const int64_t n = (int64_t)1 << k;
  const int64_t nh = n >> 1;
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * nh) return;
  int64_t b = idx / nh;
  int64_t p = idx - b * nh;
  int64_t half = (int64_t)1 << s;
  int64_t j = p & (half - 1);
  int64_t i0 = ((p >> s) << (s + 1)) + j;
  int64_t i1 = i0 + half;
  const uint32_t* xb = x + b * 16 * n;
  uint32_t* yb = y + b * 16 * n;

  uint32_t u[8], v[8], w[8], t[8], o[8];
  load_limbs<8>(u, xb + i0, n);
  load_limbs<8>(v, xb + i1, n);
  load_limbs<8>(w, tw + (j << (k - 1 - s)), nh);
  mont_mul<8>(t, v, w);
  add_mod<8>(o, u, t);
  store_limbs<8>(yb + i0, n, o);
  sub_mod<8>(o, u, t);
  store_limbs<8>(yb + i1, n, o);
}

extern "C" int dt_ntt_stage(const void* x, void* y, const void* tw,
                            int64_t batch, int k, int s, void* stream) {
  if (k < 1 || s < 0 || s >= k) return (int)cudaErrorInvalidValue;
  int64_t total = batch * ((int64_t)1 << (k - 1));
  if (total > 0) {
    int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    ntt_stage_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, batch, k, s);
  }
  return (int)cudaGetLastError();
}
