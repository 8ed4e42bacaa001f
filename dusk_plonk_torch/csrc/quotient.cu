// K14: the round-3 quotient grid, t = (arith + pi + range + logic +
// fixed_base + var_base + perm) * vh_inv at every point of the 8n coset
// (or of one shard of it), in one launch.
//
// Replaces no pallas_call site: it is the counterpart of the XLA fusion of
// the JAX engine's round3b (dusk_plonk_tpu/proving/engine.py:465-524),
// where XLA fuses the chain's field adds and subs and sends its multiplies
// to the Pallas mont_mul.  Before it the port ran each widget operation
// as its own step: one K1 launch a multiply and several torch ops an add
// over (16, 8n) planes, after four torch.roll copies for the next gate.
//
// Inputs stay in the layout they have, (..., 16, E) int32 planes of
// 16-bit Montgomery limbs: evs (z, a, b, c, d, pi), sel (11 selectors),
// sig (4 sigmas), l1, lin (the coset points), vh_inv, and the halo, z, a,
// b, d at columns E .. E + 7 (the next shard's first 8, or the coset's
// own on one device).  The next gate (i + 8) reads evs itself while
// i + 8 < E and the halo past it: no rolled copy.  The constant table
// (16, QC_COLUMNS) holds the challenges, their products and the formulas'
// constants in Montgomery form; each block turns it into words in shared
// memory once.  The arithmetic is quotient.cuh's.
//
// Bound on the H100: operations.  93 Fr multiplies an element (136
// 32-bit multiplies each: 12,648), against 24 arrays read and one written
// (1,600 bytes): at 2^19 elements 0.40 ms of multiplies, 0.25 ms of
// bytes.  Design: one thread an element, the whole chain in registers,
// one gate family at a time so that only a, b, c, d, the sum t and the
// family's own values stay live; every plane read is coalesced
// (neighbouring threads on neighbouring elements).  Blocks of 256 held
// to two an SM: ptxas caps the registers at 128 and spills 880 bytes a
// thread to L1, and the doubled occupancy pays for it.  On an H100 (SXM,
// 700 W; tools/kernel_variants/quotient_variants.py) at (16, 2^19):
// 2.06 ms, against 3.16 ms unbounded (255 registers, 168 bytes of
// spill), 2.50 ms capped at 168 registers; at 2^23 32.7 against 50.5 ms.

#include "quotient.cuh"

// threads a block and resident blocks an SM; ptxas caps the registers at
// 65,536 / (QT QMINB), at most 255.  tools/kernel_variants/
// quotient_variants.py builds this file with -DQT=... -DQMINB=... to time
// other shapes.
#ifndef QT
#define QT 256
#endif
#ifndef QMINB
#define QMINB 2
#endif

__global__ void __launch_bounds__(QT, QMINB)
quotient_kernel(QuotientIn q, const uint32_t* __restrict__ consts,
                uint32_t* __restrict__ out) {
  __shared__ uint32_t cst[QC_COLUMNS * 8];
  for (int k = threadIdx.x; k < QC_COLUMNS * 8; k += blockDim.x) {
    int col = k >> 3, w = k & 7;
    cst[k] = (consts[(2 * w) * QC_COLUMNS + col] & 0xffffu) |
             (consts[(2 * w + 1) * QC_COLUMNS + col] << 16);
  }
  __syncthreads();
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.E) return;
  uint32_t t[8];
  q14::quotient_element(t, q, i, cst);
  store_limbs<8>(out + i, q.E, t);
}

extern "C" int dt_quotient(const void* evs, const void* halo,
                           const void* sel, const void* sig, const void* l1,
                           const void* lin, const void* vh_inv,
                           const void* consts, void* out, int64_t E,
                           int64_t columns, void* stream) {
  if (columns != QC_COLUMNS || E < 8) return (int)cudaErrorInvalidValue;
  QuotientIn q{(const uint32_t*)evs, (const uint32_t*)halo,
               (const uint32_t*)sel, (const uint32_t*)sig,
               (const uint32_t*)l1, (const uint32_t*)lin,
               (const uint32_t*)vh_inv, E};
  int64_t blocks = (E + QT - 1) / QT;
  quotient_kernel<<<(unsigned)blocks, QT, 0, (cudaStream_t)stream>>>(
      q, (const uint32_t*)consts, (uint32_t*)out);
  return (int)cudaGetLastError();
}
