// K1: batched Montgomery multiply over Fr or Fq limb planes.
//
// Replaces the TPU kernel dusk_plonk_tpu/ops/pallas_field.py::mont_mul
// (_mul_kernel; also fr_mul / fq_mul), reached through
// ops/limb.py::LimbField.mul.
//
// Bound on the H100: HBM.  One Fr multiply reads 128 bytes and writes 64
// against 136 32x32 multiplies (one Fq multiply: 192 bytes in, 96 out, 300
// multiplies), so at the card's ~16.7 T multiplies/s and 3.35 TB/s the
// bytes take ~6x (Fq ~4x) longer than the multiplies.
// Design: each thread multiplies V = 2 elements of one row, on the
// carry-chain multiply of field.cuh; rows run on gridDim.y and
// element indices are 32-bit, so no thread divides.  (V = 4 took 110
// registers against V = 2's 66 for Fr and was slower at every proof shape
// on the H100: 0.0420 against 0.0398 ms at 2^19, 0.0144 against 0.0077
// ms at 65,543.)  Each operand has its own (row, limb, element) strides
// (ops/kernels.py::_row_strides) and is read in one of three ways, fixed
// for the launch:
//   VEC    element stride 1 and every limb plane 8-byte aligned at every
//          row: one 8-byte vector load a plane;
//   BCAST  element stride 0 (an (L, 1) scalar): one element, read once;
//   SCALAR anything else: element by element.
// When n is even (and the output aligned) a thread's two elements are
// neighbours and the output is written with vector stores.  Otherwise no
// limb plane past the first is aligned, every operand but a scalar reads
// element by element, and a thread's two elements lie a block width apart
// so that neighbouring threads still touch neighbouring words -- all in
// this kernel.

#include "field.cuh"

enum { VEC = 0, BCAST = 1, SCALAR = 2 };
static constexpr int V = 2;           // elements a thread

__device__ __forceinline__ void ld_vec(uint32_t (&d)[V], const uint32_t* p) {
  uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  d[0] = t.x;
  d[1] = t.y;
}
__device__ __forceinline__ void st_vec(uint32_t* p, const uint32_t (&d)[V]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(d[0], d[1]);
}

// w[e] = the element at index j[e] of the row at src (only where
// j[e] < n; the others are zero and never stored).  VEC needs the paired
// layout (j[1] = j[0] + 1).
template <int NW>
__device__ __forceinline__ void load_group(uint32_t (&w)[V][NW],
                                           const uint32_t* src,
                                           int64_t s_limb, int64_t s_elem,
                                           int mode, const int (&j)[V],
                                           int n) {
  if (mode == VEC && j[V - 1] < n) {
    src += j[0];
#pragma unroll
    for (int i = 0; i < NW; i++) {
      uint32_t lo[V], hi[V];
      ld_vec(lo, src + (2 * i) * s_limb);
      ld_vec(hi, src + (2 * i + 1) * s_limb);
#pragma unroll
      for (int e = 0; e < V; e++) w[e][i] = (lo[e] & 0xffffu) | (hi[e] << 16);
    }
  } else if (mode == BCAST) {
    load_limbs<NW>(w[0], src, s_limb);   // every j reads element 0
#pragma unroll
    for (int e = 1; e < V; e++)
#pragma unroll
      for (int i = 0; i < NW; i++) w[e][i] = w[0][i];
  } else {
#pragma unroll
    for (int e = 0; e < V; e++) {
      if (j[e] < n) {
        load_limbs<NW>(w[e], src + j[e] * s_elem, s_limb);
      } else {
#pragma unroll
        for (int i = 0; i < NW; i++) w[e][i] = 0;
      }
    }
  }
}

template <int NW>
__device__ __forceinline__ void store_group(uint32_t* dst, int n,
                                            const uint32_t (&w)[V][NW],
                                            bool vec, const int (&j)[V]) {
  if (vec && j[V - 1] < n) {
    dst += j[0];
#pragma unroll
    for (int i = 0; i < NW; i++) {
      uint32_t lo[V], hi[V];
#pragma unroll
      for (int e = 0; e < V; e++) {
        lo[e] = w[e][i] & 0xffffu;
        hi[e] = w[e][i] >> 16;
      }
      st_vec(dst + (2 * i) * n, lo);
      st_vec(dst + (2 * i + 1) * n, hi);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; e++)
      if (j[e] < n) store_limbs<NW>(dst + j[e], n, w[e]);
  }
}

template <int NW>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const uint32_t* __restrict__ a, int64_t sa_row,
                int64_t sa_limb, int64_t sa_elem, int amode,
                const uint32_t* __restrict__ b, int64_t sb_row,
                int64_t sb_limb, int64_t sb_elem, int bmode,
                uint32_t* __restrict__ out, bool out_vec, int64_t rows,
                int n) {
  // paired (out_vec): j = 2 t, 2 t + 1; spread: t, t + blockDim.x of the
  // block's 2 blockDim.x elements
  int j[V];
#pragma unroll
  for (int e = 0; e < V; e++)
    j[e] = out_vec ? (blockIdx.x * blockDim.x + threadIdx.x) * V + e
                   : (blockIdx.x * V + e) * blockDim.x + threadIdx.x;
  if (j[0] >= n) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    uint32_t x[V][NW], y[V][NW], z[V][NW];
    load_group<NW>(x, a + r * sa_row, sa_limb, sa_elem, amode, j, n);
    load_group<NW>(y, b + r * sb_row, sb_limb, sb_elem, bmode, j, n);
#pragma unroll
    for (int e = 0; e < V; e++) mont_mul<NW>(z[e], x[e], y[e]);
    store_group<NW>(out + r * (2 * NW) * (int64_t)n, n, z, out_vec, j);
  }
}

// how an operand is read (see the note at the top)
static int read_mode(const void* p, int64_t s_row, int64_t s_limb,
                     int64_t s_elem, int64_t rows) {
  if (s_elem == 0) return BCAST;
  bool aligned = (uintptr_t)p % (4 * V) == 0 && s_limb % V == 0 &&
                 (rows == 1 || s_row % V == 0);
  return s_elem == 1 && aligned ? VEC : SCALAR;
}

template <int NW>
static int launch(const void* a, int64_t sa_row, int64_t sa_limb,
                  int64_t sa_elem, const void* b, int64_t sb_row,
                  int64_t sb_limb, int64_t sb_elem, void* out, int64_t rows,
                  int64_t n, void* stream) {
  if (n > INT32_MAX - V) return (int)cudaErrorInvalidValue;
  if (rows > 0 && n > 0) {
    int threads = 256;
    int64_t groups = (n + V - 1) / V;
    dim3 grid((unsigned)((groups + threads - 1) / threads),
              (unsigned)(rows < 65535 ? rows : 65535));
    bool out_vec = (uintptr_t)out % (4 * V) == 0 && n % V == 0;
    // VEC reads need the paired layout
    int amode = read_mode(a, sa_row, sa_limb, sa_elem, rows);
    int bmode = read_mode(b, sb_row, sb_limb, sb_elem, rows);
    if (!out_vec) {
      amode = amode == VEC ? SCALAR : amode;
      bmode = bmode == VEC ? SCALAR : bmode;
    }
    mont_mul_kernel<NW><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, sa_row, sa_limb, sa_elem, amode,
        (const uint32_t*)b, sb_row, sb_limb, sb_elem, bmode, (uint32_t*)out,
        out_vec, rows, (int)n);
  }
  return (int)cudaGetLastError();
}

extern "C" int dt_mont_mul(int limbs, const void* a, int64_t sa_row,
                           int64_t sa_limb, int64_t sa_elem, const void* b,
                           int64_t sb_row, int64_t sb_limb, int64_t sb_elem,
                           void* out, int64_t rows, int64_t n,
                           void* stream) {
  if (limbs == 16)
    return launch<8>(a, sa_row, sa_limb, sa_elem, b, sb_row, sb_limb,
                     sb_elem, out, rows, n, stream);
  if (limbs == 24)
    return launch<12>(a, sa_row, sa_limb, sa_elem, b, sb_row, sb_limb,
                      sb_elem, out, rows, n, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
