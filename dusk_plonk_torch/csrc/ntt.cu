// K2: one pass of the multi-pass NTT over Fr limb planes.
//
// Replaces the TPU kernels of dusk_plonk_tpu/ops/pallas_field.py::ntt_ladder:
// _ntt_local_kernel (every stage with half < tile, on one VMEM tile) and
// _ntt_global_kernel (one stage with half >= tile over paired blocks).
//
// A transform of n = 2^k points is P = 1-3 passes (ops/kernels.py::
// ntt_passes), the Bailey split n = m_1 m_2 .. m_P with natural order in
// and out.  Pass p runs an m_p-point DFT along one digit of the index on
// every "line" of the array; a block takes a tile of C lines in shared
// memory and runs all log2(m_p) radix-2 levels there.  Before the first
// pass the input is scaled (the coset's g^i: `pre`); after each pass but the
// last, the output is multiplied by the mid twiddle w_N^{b c} (`post` mode
// 3); the last pass scales by 1/n or g^-i / n (`post` modes 1, 2) and writes
// the output in natural order.  So one transform reads and writes the array
// P times, where the stage kernel of earlier versions made k round trips,
// a bit-reversal gather and two scale passes.
//
// Line l of the pass is l = hi D + lo; its element at DFT position a sits
// at hi in_a + lo in_b + a in_s, output position c at hi out_a + lo out_b +
// c out_s (ops/kernels.py::NttPass).  The strided side of a pass (in_s or
// out_s > 1) reads or writes the C lines of a tile, adjacent in memory, as
// runs of C elements in each of the 16 limb planes.
//
// Tables are packed: 8 words (32 bytes) an element, element-major, read
// with two 16-byte loads.  `roots` holds w_m^e for e < m/2 (the in-tile
// roots); the pre / post tables are indexed by input / output position, the
// mid twiddle by c D + lo.  Direction lives in the values.
//
// Bound on the H100: integer multiplies.  (6, 16, 2^19) needs ~0.27 ms of
// them at one instruction a 32 x 32 -> 64 product (twice that as the lo and
// hi instructions the multiply issues), against 0.12 ms for one HBM read
// and write of the data.  Design: the tile (at most 2,048 elements, 64 KB)
// lives word-major in dynamic shared memory, slot e of word w at
// w * tile + swizzle(e), the bank bits XORed with the row bits so that the
// strided loads and stores of runs of C do not conflict; the input lands
// at bit-reversed positions, so the decimation-in-time levels give natural
// order in place.  Each thread runs whole butterflies: two shared-memory
// reads, one Montgomery multiply (none at the first level, whose root is
// one), one add and one sub, the root from L1.  Tiles this small let ~3
// blocks share an SM, so one block's loads and stores overlap another's
// multiplies: with one 128 KB tile an SM, the passes ran memory and
// compute phases one after the other (PERF.md, section 6).

#include "field.cuh"

struct NttPassArgs {
  int64_t n;                      // points of one transform
  int log_m, log_c, log_d;        // DFT length m, lines a tile C, line split D
  int64_t in_a, in_b, in_s;       // input offset of (l = hi D + lo, a)
  int64_t out_a, out_b, out_s;    // output offset of (l, c)
  int pre;                        // 0: none; 1: table by input position
  int post;                       // 0: none; 1: scalar; 2: table by output
                                  // position; 3: mid twiddle by c D + lo
};

static constexpr int NTT_MAX_TILE = 2048;
static constexpr int NTT_THREADS = 256;

__device__ __forceinline__ void load_packed(uint32_t (&w)[8],
                                            const uint32_t* tab, int64_t e) {
  const uint4* q = reinterpret_cast<const uint4*>(tab + 8 * e);
  uint4 lo = __ldg(q), hi = __ldg(q + 1);
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

__device__ __forceinline__ int swz(int e) { return e ^ ((e >> 5) & 31); }

__global__ void __launch_bounds__(NTT_THREADS)
ntt_pass_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                const uint32_t* __restrict__ roots,
                const uint32_t* __restrict__ pre_tab,
                const uint32_t* __restrict__ post_tab, NttPassArgs p) {
  extern __shared__ uint32_t sm[];
  const int m = 1 << p.log_m;
  const int C = 1 << p.log_c;
  const int tile = m << p.log_c;
  const int64_t n = p.n;
  const uint32_t* xb = x + (int64_t)blockIdx.y * 16 * n;
  uint32_t* yb = y + (int64_t)blockIdx.y * 16 * n;
  const int64_t l0 = (int64_t)blockIdx.x << p.log_c;
  const int64_t dmask = ((int64_t)1 << p.log_d) - 1;

  // 1. load, pre-scale, and place at the bit-reversed DFT position: element
  // (a, t) of line t goes to slot brev(a) C + t
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    int a, t;
    if (p.in_s == 1) {            // rows contiguous: a fastest
      a = i & (m - 1);
      t = i >> p.log_m;
    } else {                      // lines adjacent: t fastest
      t = i & (C - 1);
      a = i >> p.log_c;
    }
    int64_t l = l0 + t;
    int64_t pos = (l >> p.log_d) * p.in_a + (l & dmask) * p.in_b +
                  (int64_t)a * p.in_s;
    uint32_t v[8];
    load_limbs<8>(v, xb + pos, n);
    if (p.pre) {
      uint32_t s[8], r[8];
      load_packed(s, pre_tab, pos);
      mont_mul<8>(r, v, s);
#pragma unroll
      for (int w = 0; w < 8; w++) v[w] = r[w];
    }
    int br = p.log_m ? (int)(__brev((unsigned)a) >> (32 - p.log_m)) : 0;
    int e = swz(br * C + t);
#pragma unroll
    for (int w = 0; w < 8; w++) sm[w * tile + e] = v[w];
  }

  // 2. the log2(m) decimation-in-time levels, in place
  for (int s = 0; s < p.log_m; s++) {
    __syncthreads();
    const int half = 1 << s;
    for (int j = threadIdx.x; j < tile / 2; j += blockDim.x) {
      int t = j & (C - 1);
      int u = j >> p.log_c;
      int jj = u & (half - 1);
      int i0 = ((u >> s) << (s + 1)) + jj;
      int e0 = swz(i0 * C + t), e1 = swz((i0 + half) * C + t);
      uint32_t a0[8], a1[8], w[8], tw[8], o[8];
#pragma unroll
      for (int q = 0; q < 8; q++) {
        a0[q] = sm[q * tile + e0];
        a1[q] = sm[q * tile + e1];
      }
      if (s == 0) {               // the root is one: no multiply
#pragma unroll
        for (int q = 0; q < 8; q++) tw[q] = a1[q];
      } else {
        load_packed(w, roots, (int64_t)jj << (p.log_m - 1 - s));
        mont_mul<8>(tw, a1, w);
      }
      add_mod<8>(o, a0, tw);
#pragma unroll
      for (int q = 0; q < 8; q++) sm[q * tile + e0] = o[q];
      sub_mod<8>(o, a0, tw);
#pragma unroll
      for (int q = 0; q < 8; q++) sm[q * tile + e1] = o[q];
    }
  }
  __syncthreads();

  // 3. multiply by the mid twiddle or the post-scale, and store
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    int c, t;
    if (p.out_s == 1) {
      c = i & (m - 1);
      t = i >> p.log_m;
    } else {
      t = i & (C - 1);
      c = i >> p.log_c;
    }
    int64_t l = l0 + t;
    int64_t lo = l & dmask;
    int64_t pos = (l >> p.log_d) * p.out_a + lo * p.out_b +
                  (int64_t)c * p.out_s;
    int e = swz(c * C + t);
    uint32_t v[8];
#pragma unroll
    for (int w = 0; w < 8; w++) v[w] = sm[w * tile + e];
    if (p.post) {
      int64_t idx = p.post == 1 ? 0
                    : p.post == 2 ? pos
                                  : ((int64_t)c << p.log_d) + lo;
      uint32_t s[8], r[8];
      load_packed(s, post_tab, idx);
      mont_mul<8>(r, v, s);
      store_limbs<8>(yb + pos, n, r);
    } else {
      store_limbs<8>(yb + pos, n, v);
    }
  }
}

static int ilog2(int64_t v) {
  int r = 0;
  while (((int64_t)1 << r) < v) r++;
  return ((int64_t)1 << r) == v ? r : -1;
}

extern "C" int dt_ntt_pass(const void* x, void* y, const void* roots,
                           const void* pre_tab, const void* post_tab,
                           int64_t batch, int k, int log_m, int lines,
                           int64_t D, int64_t in_a, int64_t in_b,
                           int64_t in_s, int64_t out_a, int64_t out_b,
                           int64_t out_s, int pre, int post, void* stream) {
  NttPassArgs p;
  p.n = (int64_t)1 << k;
  p.log_m = log_m;
  p.log_c = ilog2(lines);
  p.log_d = ilog2(D);
  p.in_a = in_a; p.in_b = in_b; p.in_s = in_s;
  p.out_a = out_a; p.out_b = out_b; p.out_s = out_s;
  p.pre = pre;
  p.post = post;
  const int64_t tile = (int64_t)lines << log_m;
  if (k < 0 || k > 30 || log_m < 0 || log_m > k || p.log_c < 0 ||
      p.log_d < 0 || tile > NTT_MAX_TILE || (p.n >> log_m) % lines != 0 ||
      pre < 0 || pre > 1 || post < 0 || post > 3 || batch > 65535 ||
      (pre && !pre_tab) || (post && !post_tab))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaGetLastError();
  const int smem = (int)(tile * 8 * sizeof(uint32_t));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = (int)(tile / 2);
  threads = threads < 32 ? 32 : threads > NTT_THREADS ? NTT_THREADS : threads;
  dim3 grid((unsigned)((p.n >> log_m) / lines), (unsigned)batch);
  ntt_pass_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)roots,
      (const uint32_t*)pre_tab, (const uint32_t*)post_tab, p);
  return (int)cudaGetLastError();
}
