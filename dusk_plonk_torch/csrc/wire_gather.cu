// K15: a proof's four wire columns, gathered on the card from the witness
// table and put in Montgomery form.
//
// Replaces no TPU kernel: the JAX engine builds the columns on the host
// (dusk_plonk_tpu/proving/engine.py:190-194, a numpy gather, widen and
// transpose of the witness list) and multiplies them by R^2 on the device.
// Here the host sends the witness table once a proof, (nw + 1) rows of 8
// canonical 32-bit words (row nw: the zero row that the domain's padding
// gates point at), and this kernel reads it through the circuit's
// compile-time wire plan cols (W, n) int32:
//   out[j, :, i] = table[cols[j, i]] R^2 R^-1 mod r = table[cols[j, i]] R,
// the (W, 16, n) int32 limb planes that K1's multiply by R^2 gives, limb
// for limb (the same field.cuh multiply on the same words).
//
// Bound on the H100: HBM.  A (wire, point) reads its index (4 bytes) and a
// 32-byte row and writes 16 limb planes of 4 bytes (64), against one Fr
// multiply (136 32x32 products): at 2^20 points, 4 wires, 0.125 ms of
// bytes against 0.034 ms of multiplies.
// Design: one thread a (wire, point), wires on gridDim.y; the row in two
// 16-byte loads (rows are 32-byte aligned), the multiply by the immediate
// R^2, the 16 limbs stored as 16 coalesced planes (neighbouring threads on
// neighbouring points).  A circuit's wire plan reads its witness rows
// nearly in order, so neighbouring threads read neighbouring rows and the
// 32 MiB table of a 2^20 proof stays in L2 between the four wires.

#include "field.cuh"

// R^2 mod r (R = 2^256), least significant word first
#define FR_R2_WORDS                                                  \
  {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu, 0x7254398fu,  \
   0x05d31496u, 0x9f59ff11u, 0x0748d9d9u}

__global__ void __launch_bounds__(256)
wire_gather_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ cols,
                   uint32_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t j = blockIdx.y;
  int64_t row = cols[j * n + i];
  uint4 lo = __ldg(table + 2 * row);
  uint4 hi = __ldg(table + 2 * row + 1);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const uint32_t r2[8] = FR_R2_WORDS;
  uint32_t z[8];
  mont_mul<8>(z, w, r2);
  store_limbs<8>(out + j * 16 * n + i, n, z);
}

// table (rows, 8) words, cols (wires, n) int32 with every index in
// [0, rows), out (wires, 16, n) int32
extern "C" int dt_wire_gather(const void* table, const void* cols, void* out,
                              int64_t wires, int64_t n, void* stream) {
  if (n > INT32_MAX || wires > 65535 || (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (wires > 0 && n > 0) {
    int threads = 256;
    dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)wires);
    wire_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (const int32_t*)cols, (uint32_t*)out, (int)n);
  }
  return (int)cudaGetLastError();
}
