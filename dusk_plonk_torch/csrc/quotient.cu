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
// Bound on the H100: operations.  86 Fr multiplies a point, 112 32-bit
// products each (quotient.cuh::fr_mont_mul: 9,632 a point), against 24
// arrays read and one written (1,600 bytes): at 2^19 points 0.30 ms of
// multiplies, 0.25 ms of bytes.  The one-thread design's count, 93 Fr
// multiplies of 136 products, gave 0.40 ms.
// What bounds it in fact is the multiply pipe: the Fr multiply alone
// (tools/kernel_variants/fr_mul_peak.cu) peaks at 5.5e10 a second on an
// H100 at any occupancy from 8 warps an SM, so the 86 multiplies this
// design spends a point take at least 0.82 ms at 2^19.  The one-thread
// design before it (one thread a point, the whole chain in registers;
// tools/kernel_variants/quotient_var.cu) lost the rest to registers:
// capped at 128 it spilled 880 bytes a thread, uncapped it left one
// block of 256 an SM.
//
// Design: a block is Q14_GROUPS = 4 warps on the same 32 points.  Each
// warp runs one group of gate families (quotient.cuh::group_terms: 23,
// 22, 20 and 19 multiplies), loading only the planes its families read
// (lane l on point l: every load coalesced), so a thread holds one
// family's values at a time: 96 registers at five blocks of 128 an SM.
// The planes one family reads skip L1, and the evs rows, which every
// group reads, stay in it (quotient.cuh::ld_pass, ld_keep).  Each
// group's two sums (its families' terms, and its part of the permutation
// term) meet in shared memory; the last group adds them to its own,
// multiplies by alpha and vh_inv (quotient.cuh::combine) and stores.
// Lanes past E (the ragged edge) compute nothing and store nothing.  On
// an H100 (SXM, 700 W; chip_smoke.py and tools/kernel_variants/
// quotient_variants.py): 1.31-1.44 ms at (16, 2^19) and 21.9-22.9 ms at
// (16, 2^23), against the one-thread design's 2.06-2.08 and 32.8-33.4
// ms in the same runs.  More resident warps beat fewer spills: 96
// registers spill ~540 bytes a thread to L1, and the shape with the
// fewest spills (168 registers, 12 bytes, four blocks of 96) runs 1.93
// ms.

#include "quotient.cuh"

// resident blocks an SM: ptxas caps the registers at 65,536 / (QT QMINB),
// at most 255.  tools/kernel_variants/quotient_variants.py builds this
// file with -DQMINB=.. to time other shapes.
#ifndef QMINB
#define QMINB 5
#endif
#define QT (32 * Q14_GROUPS)

__global__ void __launch_bounds__(QT, QMINB)
quotient_groups_kernel(QuotientIn q, const uint32_t* __restrict__ consts,
                       uint32_t* __restrict__ out) {
  __shared__ uint32_t cst[QC_COLUMNS * 8];
  // the first Q14_GROUPS - 1 groups' sums: [group][fam, perm][word][lane],
  // lane-minor so that a warp's stores and loads hit 32 banks
  __shared__ uint32_t part[Q14_GROUPS - 1][2][8][32];
  for (int k = threadIdx.x; k < QC_COLUMNS * 8; k += QT) {
    int col = k >> 3, w = k & 7;
    cst[k] = (consts[(2 * w) * QC_COLUMNS + col] & 0xffffu) |
             (consts[(2 * w + 1) * QC_COLUMNS + col] << 16);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * 32 + lane;
  const bool live = i < q.E;
  q14::Fe fam = {0}, perm = {0};
  if (live) q14::group_terms(g, fam, perm, q, i, cst);
  if (g < Q14_GROUPS - 1) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      part[g][0][k][lane] = fam[k];
      part[g][1][k][lane] = perm[k];
    }
  }
  __syncthreads();
  if (g < Q14_GROUPS - 1 || !live) return;
#pragma unroll
  for (int h = 0; h < Q14_GROUPS - 1; h++) {
    q14::Fe x;
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = part[h][0][k][lane];
    q14::add(fam, fam, x);
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = part[h][1][k][lane];
    q14::add(perm, perm, x);
  }
  q14::Fe t;
  q14::combine(t, fam, perm, q, i, cst);
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
  int64_t blocks = (E + 31) / 32;
  quotient_groups_kernel<<<(unsigned)blocks, QT, 0,
                           (cudaStream_t)stream>>>(
      q, (const uint32_t*)consts, (uint32_t*)out);
  return (int)cudaGetLastError();
}
