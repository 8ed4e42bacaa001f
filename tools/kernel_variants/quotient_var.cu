// K14's earlier design, kept for timing beside the package's kernel
// (quotient_variants.py): one thread a point, the whole widget chain of
// proving/widgets.py in registers, one gate family after another, blocks
// of QT threads held to QMINB an SM (256 and 2: ptxas caps the registers
// at 128 and spills 880 bytes a thread).  Its arithmetic is the earlier one
// (csrc/field.cuh's shared mont_mul<8>, 93 multiplies a point); every
// value is canonical, so its output equals the package's kernel limb for
// limb.  The enums, QuotientIn and the table's layout come from the
// package's quotient.cuh.
//
//   nvcc ... -shared -I ../../dusk_plonk_torch/csrc \
//       -o libq14_one_thread.so quotient_var.cu

#include "quotient.cuh"

namespace q14_one {

typedef uint32_t Fe[8];

__device__ __forceinline__ void mul(Fe& r, const Fe& a, const Fe& b) {
  mont_mul<8>(r, a, b);
}
__device__ __forceinline__ void add(Fe& r, const Fe& a, const Fe& b) {
  add_mod<8>(r, a, b);
}
__device__ __forceinline__ void sub(Fe& r, const Fe& a, const Fe& b) {
  sub_mod<8>(r, a, b);
}

// element i of row `row` of a (rows, 16, E) stack
__device__ __forceinline__ void ld(Fe& w, const uint32_t* base, int row,
                                   int64_t i, int64_t E) {
  load_limbs<8>(w, base + (int64_t)row * 16 * E + i, E);
}

// element i + 8 of an evs row: from evs while inside, else from the halo
__device__ __forceinline__ void ld_next(Fe& w, const QuotientIn& q,
                                        int ev_row, int halo_row,
                                        int64_t i) {
  int64_t j = i + 8;
  if (j < q.E)
    ld(w, q.evs, ev_row, j, q.E);
  else
    load_limbs<8>(w, q.halo + (int64_t)halo_row * 16 * 8 + (j - q.E), 8);
}

// column c of the table, 8 words a column
__device__ __forceinline__ void kc(Fe& w, const uint32_t* cst, int c) {
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = cst[8 * c + k];
}

// r = x - 4 y
__device__ __forceinline__ void minus4(Fe& r, const Fe& x, const Fe& y) {
  Fe f;
  add(f, y, y);
  add(f, f, f);
  sub(r, x, f);
}

// r = 3 x
__device__ __forceinline__ void times3(Fe& r, const Fe& x) {
  Fe f;
  add(f, x, x);
  add(r, f, x);
}

// f (f - 1)(f - 2)(f - 3) = u (u + 2) with u = f^2 - 3f
__device__ __forceinline__ void delta(Fe& r, const Fe& f,
                                      const uint32_t* cst) {
  Fe u, v;
  mul(u, f, f);
  times3(v, f);
  sub(u, u, v);
  kc(v, cst, QC_TWO);
  add(v, u, v);
  mul(r, u, v);
}

// s = s * (selector row `sel` at i) * (column `sep`); t += s
__device__ __forceinline__ void close_family(Fe& t, Fe& s,
                                             const QuotientIn& q, int sel,
                                             int sep, int64_t i,
                                             const uint32_t* cst) {
  Fe y;
  ld(y, q.sel, sel, i, q.E);
  mul(s, s, y);
  kc(y, cst, sep);
  mul(s, s, y);
  add(t, t, s);
}

// s += x * (column k)
__device__ __forceinline__ void add_scaled(Fe& s, Fe& x, int k,
                                           const uint32_t* cst) {
  Fe y;
  kc(y, cst, k);
  mul(x, x, y);
  add(s, s, x);
}

__device__ __forceinline__ void quotient_element(Fe& t, const QuotientIn& q,
                                                 int64_t i,
                                                 const uint32_t* cst) {
  const int64_t E = q.E;
  Fe a, b, c, d, s, x, y;

  // arithmetic: (a b q_m + a q_l + b q_r + c q_o + d q_4 + q_c) q_arith,
  // then + pi
  ld(a, q.evs, EV_A, i, E);
  ld(b, q.evs, EV_B, i, E);
  ld(c, q.evs, EV_C, i, E);
  ld(d, q.evs, EV_D, i, E);
  mul(x, a, b);
  ld(y, q.sel, Q_M, i, E);
  mul(s, x, y);
  ld(y, q.sel, Q_L, i, E);
  mul(y, a, y);
  add(s, s, y);
  ld(y, q.sel, Q_R, i, E);
  mul(y, b, y);
  add(s, s, y);
  ld(y, q.sel, Q_O, i, E);
  mul(y, c, y);
  add(s, s, y);
  ld(y, q.sel, Q_4, i, E);
  mul(y, d, y);
  add(s, s, y);
  ld(y, q.sel, Q_C, i, E);
  add(s, s, y);
  ld(y, q.sel, Q_ARITH, i, E);
  mul(t, s, y);
  ld(y, q.evs, EV_PI, i, E);
  add(t, t, y);

  // range: (D(c - 4d) + D(b - 4c) k + D(a - 4b) k^2 + D(d' - 4a) k^3)
  // q_range sep
  minus4(x, c, d);
  delta(s, x, cst);
  minus4(x, b, c);
  delta(x, x, cst);
  add_scaled(s, x, QC_RANGE_K1, cst);
  minus4(x, a, b);
  delta(x, x, cst);
  add_scaled(s, x, QC_RANGE_K2, cst);
  ld_next(x, q, EV_D, HALO_D, i);
  minus4(x, x, a);
  delta(x, x, cst);
  add_scaled(s, x, QC_RANGE_K3, cst);
  close_family(t, s, q, Q_RANGE, QC_RANGE_SEP, i, cst);

  // logic, on the quads qa = a' - 4a, qb = b' - 4b, qd = d' - 4d, w = c
  {
    Fe qa, qb, qd, apb, f;
    ld_next(x, q, EV_A, HALO_A, i);
    minus4(qa, x, a);
    ld_next(x, q, EV_B, HALO_B, i);
    minus4(qb, x, b);
    ld_next(x, q, EV_D, HALO_D, i);
    minus4(qd, x, d);
    delta(s, qa, cst);
    delta(x, qb, cst);
    add_scaled(s, x, QC_LOGIC_K1, cst);
    delta(x, qd, cst);
    add_scaled(s, x, QC_LOGIC_K2, cst);
    mul(x, qa, qb);
    sub(x, c, x);
    add_scaled(s, x, QC_LOGIC_K3, cst);
    // q_c (9 qd - 3 (qa + qb)) + 3 (qa + qb + qd) - 2F,
    // F = w (w (4w - 18 (qa + qb) + 81) + 18 (qa^2 + qb^2)
    //        - 81 (qa + qb) + 83)
    add(apb, qa, qb);
    add(x, c, c);
    add(x, x, x);
    kc(y, cst, QC_EIGHTEEN);
    mul(y, y, apb);
    sub(x, x, y);
    kc(y, cst, QC_81);
    add(x, x, y);
    mul(f, c, x);
    mul(x, qa, qa);
    mul(y, qb, qb);
    add(x, x, y);
    kc(y, cst, QC_EIGHTEEN);
    mul(x, x, y);
    kc(y, cst, QC_81);
    mul(y, y, apb);
    sub(x, x, y);
    kc(y, cst, QC_83);
    add(x, x, y);
    add(f, f, x);
    mul(f, c, f);
    add(x, apb, qd);
    times3(x, x);
    add(f, f, f);
    sub(f, x, f);
    kc(y, cst, QC_NINE);
    mul(x, y, qd);
    times3(y, apb);
    sub(x, x, y);
    ld(y, q.sel, Q_C, i, E);
    mul(x, y, x);
    add(x, x, f);
    add_scaled(s, x, QC_LOGIC_K4, cst);
    close_family(t, s, q, Q_LOGIC, QC_LOGIC_SEP, i, cst);
  }

  // fixed base: a, b = acc_x, acc_y; c = xy_alpha; d = accumulated bit;
  // q_l, q_r, q_c = x_beta, y_beta, xy_beta
  {
    Fe bit, b2, xa, ya, kd;
    ld_next(x, q, EV_D, HALO_D, i);
    add(y, d, d);
    sub(bit, x, y);
    mul(b2, bit, bit);
    kc(y, cst, QC_ONE);
    sub(x, b2, y);
    mul(s, bit, x);                      // bit (bit - 1)(bit + 1)
    ld(x, q.sel, Q_R, i, E);
    sub(x, x, y);
    mul(x, b2, x);
    add(ya, x, y);                       // bit^2 (y_beta - 1) + 1
    ld(x, q.sel, Q_L, i, E);
    mul(xa, x, bit);                     // x_beta bit
    ld(x, q.sel, Q_C, i, E);
    mul(x, bit, x);
    sub(x, x, c);
    add_scaled(s, x, QC_FIXED_K1, cst);
    mul(kd, c, a);
    mul(kd, kd, b);
    kc(y, cst, QC_JUBJUB_D);
    mul(kd, kd, y);                      // xy_alpha acc_x acc_y d
    ld_next(x, q, EV_A, HALO_A, i);
    mul(y, x, kd);
    add(x, x, y);
    mul(y, xa, b);
    sub(x, x, y);
    mul(y, ya, a);
    sub(x, x, y);
    add_scaled(s, x, QC_FIXED_K2, cst);
    ld_next(x, q, EV_B, HALO_B, i);
    mul(y, x, kd);
    sub(x, x, y);
    mul(y, ya, b);
    sub(x, x, y);
    mul(y, xa, a);
    sub(x, x, y);
    add_scaled(s, x, QC_FIXED_K3, cst);
    close_family(t, s, q, Q_FIXED, QC_FIXED_SEP, i, cst);
  }

  // variable base: (x1, y1, x2, y2) = (a, b, c, d), (x3, y3, x1 y2) =
  // (a', b', d')
  {
    Fe dn, e, g;
    ld_next(dn, q, EV_D, HALO_D, i);
    mul(s, a, d);
    sub(s, s, dn);
    mul(e, b, c);                        // y1 x2
    kc(y, cst, QC_JUBJUB_D);
    mul(g, y, dn);
    mul(g, g, e);                        // d x1y2 y1x2
    add(x, dn, e);
    ld_next(y, q, EV_A, HALO_A, i);
    mul(e, y, g);
    add(y, y, e);
    sub(x, x, y);
    add_scaled(s, x, QC_VAR_K1, cst);
    mul(x, b, d);
    mul(y, a, c);
    add(x, x, y);
    ld_next(y, q, EV_B, HALO_B, i);
    mul(e, y, g);
    sub(y, y, e);
    sub(x, x, y);
    add_scaled(s, x, QC_VAR_K2, cst);
    close_family(t, s, q, Q_VAR, QC_VAR_SEP, i, cst);
  }

  // permutation: alpha (P1 z - P2 z' + alpha (z - 1) L1), P1 the identity
  // wires' product, P2 the sigma wires'
  {
    Fe bx, g;
    const Fe* w[4] = {&a, &b, &c, &d};
    kc(y, cst, QC_BETA);
    ld(x, q.lin, 0, i, E);
    mul(bx, y, x);                       // beta X
    add(s, a, bx);
    kc(y, cst, QC_GAMMA);
    add(s, s, y);
#pragma unroll
    for (int k = 1; k < 4; k++) {
      kc(y, cst, QC_PERM_K1 + k - 1);
      mul(x, y, bx);
      add(x, *w[k], x);
      kc(y, cst, QC_GAMMA);
      add(x, x, y);
      mul(s, s, x);
    }
    ld(x, q.evs, EV_Z, i, E);
    mul(s, s, x);
#pragma unroll
    for (int k = 0; k < 4; k++) {
      kc(y, cst, QC_BETA);
      ld(x, q.sig, k, i, E);
      mul(x, y, x);
      add(x, *w[k], x);
      kc(y, cst, QC_GAMMA);
      if (k == 0) {
        add(g, x, y);
      } else {
        add(x, x, y);
        mul(g, g, x);
      }
    }
    ld_next(x, q, EV_Z, HALO_Z, i);
    mul(g, g, x);
    sub(s, s, g);
    ld(x, q.evs, EV_Z, i, E);
    kc(y, cst, QC_ONE);
    sub(x, x, y);
    ld(y, q.l1, 0, i, E);
    mul(x, x, y);
    kc(y, cst, QC_ALPHA);
    mul(x, x, y);
    add(s, s, x);
    mul(s, s, y);
    add(t, t, s);
  }

  ld(y, q.vh_inv, 0, i, E);
  mul(t, t, y);
}

}  // namespace q14_one

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
quotient_one_thread_kernel(QuotientIn q, const uint32_t* __restrict__ consts,
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
  q14_one::quotient_element(t, q, i, cst);
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
  quotient_one_thread_kernel<<<(unsigned)blocks, QT, 0,
                               (cudaStream_t)stream>>>(
      q, (const uint32_t*)consts, (uint32_t*)out);
  return (int)cudaGetLastError();
}
