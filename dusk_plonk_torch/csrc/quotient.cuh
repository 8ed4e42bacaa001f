// K14's arithmetic: the round-3 quotient t(X) / Z_H(X) at one point of the
// 8n coset, the widget chain of proving/widgets.py on Fr carry chains, cut
// into gate-family groups that the warps of a block run side by side on
// the same points (quotient.cu), and the combine that sums their terms.
//
// Kept apart from quotient.cu so that the same functions compile on the
// host (tests/test_torch_quotient_model.py builds them with g++ over a
// model of the PTX carry flag and holds each family, each group and the
// combined grid against the plain version).
//
// Every value is canonical, and add_mod / sub_mod / mul return canonical
// values, so any algebraically equal form of the formulas, and any
// grouping of the terms, gives the plain version's limbs exactly.  The
// forms used here, against the widget formulas (multiplies a point: this
// 86, the plain chain 116 with l1 alpha^2 and the final vh_inv):
//   * a multiply by a small constant is a few adds: 2, 3 and 4; 9, 18
//     and 81 in the logic gate; the permutation's coset constants 7, 13
//     and 17;
//   * the digit check f (f - 1)(f - 2)(f - 3) is u (u + 2), u = f^2 - 3f
//     (2 multiplies, not 3; seven checks a point);
//   * the fixed-base gate forms xy_alpha acc_x acc_y d once for both
//     accumulator rows;
//   * the permutation term is alpha (P1 z - P2 z' + alpha (z - 1) L1),
//     one multiply by alpha fewer and none by alpha^2 a point;
//   * every challenge-only product (alpha^2, the separators' powers) and
//     every other constant comes from the table (QuotientColumn),
//     computed once a proof on the host.
// The multiplies: arithmetic 7, range 13, logic 18, fixed base 19,
// variable base 12, permutation 5 (P1 z) + 8 (P2 z') + 2 (alpha (z - 1)
// L1), the combine 2 (alpha, vh_inv).
#pragma once

#include "field.cuh"

// columns of the constant table, ops/kernels.py::QUOTIENT_TABLE's order.
// The kernel reads no QC_ALPHA_SQ, QC_THREE, QC_FOUR, QC_NINE,
// QC_EIGHTEEN or QC_PERM_K1..3: it multiplies by 3, 4, 9, 18, 81 and the
// permutation's 7, 13, 17 with adds (below).  quotient_plain and the
// `mulk` probe of tools/kernel_variants/quotient_variants.py read them;
// tests/test_torch_quotient_model.py holds the add chains' constants to
// fields/constants.py's PERM_K1..3.
enum QuotientColumn {
  QC_ALPHA, QC_BETA, QC_GAMMA, QC_RANGE_SEP, QC_LOGIC_SEP, QC_FIXED_SEP,
  QC_VAR_SEP, QC_ALPHA_SQ,
  QC_RANGE_K1, QC_RANGE_K2, QC_RANGE_K3,
  QC_LOGIC_K1, QC_LOGIC_K2, QC_LOGIC_K3, QC_LOGIC_K4,
  QC_FIXED_K1, QC_FIXED_K2, QC_FIXED_K3,
  QC_VAR_K1, QC_VAR_K2,
  QC_ONE, QC_TWO, QC_THREE, QC_FOUR, QC_NINE, QC_EIGHTEEN, QC_81, QC_83,
  QC_JUBJUB_D, QC_PERM_K1, QC_PERM_K2, QC_PERM_K3,
  QC_COLUMNS
};

// rows of the inputs: evs (6, 16, E), halo (4, 16, 8), sel (11, 16, E) in
// proving/keys.py::SELECTOR_NAMES' order, sig (4, 16, E)
enum { EV_Z, EV_A, EV_B, EV_C, EV_D, EV_PI };
enum { HALO_Z, HALO_A, HALO_B, HALO_D };
enum { Q_M, Q_L, Q_R, Q_O, Q_C, Q_4, Q_ARITH, Q_RANGE, Q_LOGIC, Q_FIXED,
       Q_VAR };

// the arrays of one launch, all (..., 16, E) int32 limb planes but the
// halo: z, a, b, d at columns E .. E + 7 (the first 8 of the next shard,
// or of the coset itself on one device)
struct QuotientIn {
  const uint32_t* evs;
  const uint32_t* halo;
  const uint32_t* sel;
  const uint32_t* sig;
  const uint32_t* l1;
  const uint32_t* lin;
  const uint32_t* vh_inv;
  int64_t E;
};

// The gate-family groups, one a warp of a block (quotient.cu)
#define Q14_GROUPS 4

// Fr's Montgomery multiply with the modulus's shape.  -r^-1 mod 2^32 is
// 2^32 - 1, so a row's m is -e0 (e0 the accumulator's low word): a
// negation, not a multiply.  r's low words are r0 = 1 and r1 = 2^32 - 1,
// so m r0 = m and m r1 = 2^32 (m - c) + e0 with c = (e0 != 0): two adds
// each instead of two multiplies.  The rows keep field.cuh::mont_row's
// two accumulators and add the same 64-bit products, so every carry
// chain carries what it carries there, and the result is mont_mul<8>'s.
// A row: 16 a b products and 6 m r products (24 with m in mont_row).
template <bool FIRST>
__device__ __forceinline__ void fr_row(uint32_t (&even)[8],
                                       uint32_t (&odd)[8],
                                       const uint32_t (&a)[8],
                                       const uint32_t (&p)[8],
                                       uint32_t bi) {
  if (FIRST) {
    mul_row<8>(odd, a + 1, bi);
    mul_row<8>(even, a, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    mad_row_shift<8>(odd, a + 1, bi);
    mad_row<8>(even, a, bi);
    odd[7] = addc(odd[7], 0);
  }
  uint32_t e0 = even[0];
  uint32_t m = sub_cc(0, e0);           // borrow: c = (e0 != 0)
  uint32_t mh = subc(m, 0);             // m - c, m r1's high word
  // odd += m (r1, r3, r5, r7) at word pairs: r1's pair is (e0, m - c)
  odd[0] = add_cc(odd[0], e0);
  odd[1] = addc_cc(odd[1], mh);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    odd[j] = madc_lo_cc(p[j + 1], m, odd[j]);
    odd[j + 1] = madc_hi_cc(p[j + 1], m, odd[j + 1]);
  }
  // even += m (r0, r2, r4, r6): r0's pair is (m, 0); e0 + m is 0 with a
  // carry of c
  even[0] = add_cc(e0, m);
  even[1] = addc_cc(even[1], 0);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    even[j] = madc_lo_cc(p[j], m, even[j]);
    even[j + 1] = madc_hi_cc(p[j], m, even[j + 1]);
  }
  odd[7] = addc(odd[7], 0);
}

__device__ __forceinline__ void fr_mont_mul(uint32_t (&r)[8],
                                            const uint32_t (&a)[8],
                                            const uint32_t (&b)[8]) {
  uint32_t p[8];
  Modulus<8>::words(p);
  uint32_t even[8], odd[8];
  fr_row<true>(even, odd, a, p, b[0]);
  fr_row<false>(odd, even, a, p, b[1]);
#pragma unroll
  for (int i = 2; i < 8; i += 2) {
    fr_row<false>(even, odd, a, p, b[i]);
    fr_row<false>(odd, even, a, p, b[i + 1]);
  }
  even[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < 7; j++) even[j] = addc_cc(even[j], odd[j + 1]);
  even[7] = addc(even[7], 0);
  cond_sub_p<8>(r, even, 0);
}

namespace q14 {

typedef uint32_t Fe[8];

__device__ __forceinline__ void mul(Fe& r, const Fe& a, const Fe& b) {
  fr_mont_mul(r, a, b);
}
__device__ __forceinline__ void add(Fe& r, const Fe& a, const Fe& b) {
  add_mod<8>(r, a, b);
}
__device__ __forceinline__ void sub(Fe& r, const Fe& a, const Fe& b) {
  sub_mod<8>(r, a, b);
}

// One limb word of a plane, with an L1 eviction hint: the evs rows, which
// every group of a block reads, stay in L1 last (ld_keep); the planes one
// family reads skip it (ld_pass).  The host model reads them plainly.
__device__ __forceinline__ uint32_t ld_keep(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  uint32_t v;
  asm("ld.global.nc.L1::evict_last.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}
__device__ __forceinline__ uint32_t ld_pass(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}

// element i of row `row` of a (rows, 16, E) stack, its limbs at stride E
template <uint32_t (*LOAD)(const uint32_t*)>
__device__ __forceinline__ void ld_plane(Fe& w, const uint32_t* base,
                                         int row, int64_t i, int64_t E) {
  const uint32_t* src = base + (int64_t)row * 16 * E + i;
#pragma unroll
  for (int k = 0; k < 8; k++)
    w[k] = (LOAD(src + (2 * k) * E) & 0xffffu) |
           (LOAD(src + (2 * k + 1) * E) << 16);
}

// an evs row's element i
__device__ __forceinline__ void ld(Fe& w, const uint32_t* base, int row,
                                   int64_t i, int64_t E) {
  ld_plane<ld_keep>(w, base, row, i, E);
}

// element i of a plane that one family of the block reads
__device__ __forceinline__ void ld1(Fe& w, const uint32_t* base, int row,
                                    int64_t i, int64_t E) {
  ld_plane<ld_pass>(w, base, row, i, E);
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

// r = 9 x
__device__ __forceinline__ void times9(Fe& r, const Fe& x) {
  Fe f;
  add(f, x, x);
  add(f, f, f);
  add(f, f, f);
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
  ld1(y, q.sel, sel, i, q.E);
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

// -- the gate families: each loads the planes it reads and adds its term --
//
// The families add into a group's `fam` sum; the permutation's three parts
// into its `perm` sum, which the combine multiplies by alpha.

// fam += (a b q_m + a q_l + b q_r + c q_o + d q_4 + q_c) q_arith + pi  [7]
__device__ __forceinline__ void arithmetic(Fe& t, const QuotientIn& q,
                                           int64_t i) {
  const int64_t E = q.E;
  Fe a, b, s, y;
  ld(a, q.evs, EV_A, i, E);
  ld(b, q.evs, EV_B, i, E);
  mul(s, a, b);
  ld1(y, q.sel, Q_M, i, E);
  mul(s, s, y);
  ld1(y, q.sel, Q_L, i, E);
  mul(y, a, y);
  add(s, s, y);
  ld1(y, q.sel, Q_R, i, E);
  mul(y, b, y);
  add(s, s, y);
  ld(a, q.evs, EV_C, i, E);
  ld1(y, q.sel, Q_O, i, E);
  mul(y, a, y);
  add(s, s, y);
  ld(a, q.evs, EV_D, i, E);
  ld1(y, q.sel, Q_4, i, E);
  mul(y, a, y);
  add(s, s, y);
  ld1(y, q.sel, Q_C, i, E);
  add(s, s, y);
  ld1(y, q.sel, Q_ARITH, i, E);
  mul(s, s, y);
  ld(y, q.evs, EV_PI, i, E);
  add(s, s, y);
  add(t, t, s);
}

// fam += (D(c - 4d) + D(b - 4c) k + D(a - 4b) k^2 + D(d' - 4a) k^3)
// q_range sep  [13]
__device__ __forceinline__ void range(Fe& t, const QuotientIn& q,
                                      int64_t i, const uint32_t* cst) {
  const int64_t E = q.E;
  Fe hi, lo, s, x;
  ld(lo, q.evs, EV_D, i, E);
  ld(hi, q.evs, EV_C, i, E);
  minus4(x, hi, lo);                    // c - 4d
  delta(s, x, cst);
  ld(lo, q.evs, EV_B, i, E);
  minus4(x, lo, hi);                    // b - 4c
  delta(x, x, cst);
  add_scaled(s, x, QC_RANGE_K1, cst);
  ld(hi, q.evs, EV_A, i, E);
  minus4(x, hi, lo);                    // a - 4b
  delta(x, x, cst);
  add_scaled(s, x, QC_RANGE_K2, cst);
  ld_next(lo, q, EV_D, HALO_D, i);
  minus4(x, lo, hi);                    // d' - 4a
  delta(x, x, cst);
  add_scaled(s, x, QC_RANGE_K3, cst);
  close_family(t, s, q, Q_RANGE, QC_RANGE_SEP, i, cst);
}

// fam += logic on the quads qa = a' - 4a, qb = b' - 4b, qd = d' - 4d and
// w = c  [18]
__device__ __forceinline__ void logic(Fe& t, const QuotientIn& q,
                                      int64_t i, const uint32_t* cst) {
  const int64_t E = q.E;
  Fe qa, qb, qd, s, x, y;
  ld_next(x, q, EV_A, HALO_A, i);
  ld(y, q.evs, EV_A, i, E);
  minus4(qa, x, y);
  ld_next(x, q, EV_B, HALO_B, i);
  ld(y, q.evs, EV_B, i, E);
  minus4(qb, x, y);
  ld_next(x, q, EV_D, HALO_D, i);
  ld(y, q.evs, EV_D, i, E);
  minus4(qd, x, y);
  delta(s, qa, cst);
  delta(x, qb, cst);
  add_scaled(s, x, QC_LOGIC_K1, cst);
  delta(x, qd, cst);
  add_scaled(s, x, QC_LOGIC_K2, cst);
  mul(x, qa, qb);
  ld(y, q.evs, EV_C, i, E);
  sub(x, y, x);
  add_scaled(s, x, QC_LOGIC_K3, cst);
  // q_c (9 qd - 3 (qa + qb)) + 3 (qa + qb + qd) - 2F,
  // F = w (w (4w - 18 (qa + qb) + 81) + 18 (qa^2 + qb^2)
  //        - 81 (qa + qb) + 83), the multiplies by 9, 18 and 81 as adds
  {
    Fe apb, f, w;
    add(apb, qa, qb);
    ld(w, q.evs, EV_C, i, E);
    add(x, w, w);
    add(x, x, x);
    times9(y, apb);
    add(y, y, y);
    sub(x, x, y);
    kc(y, cst, QC_81);
    add(x, x, y);
    mul(f, w, x);
    mul(x, qa, qa);
    mul(y, qb, qb);
    add(x, x, y);
    times9(x, x);
    add(x, x, x);
    times9(y, apb);
    times9(y, y);
    sub(x, x, y);
    kc(y, cst, QC_83);
    add(x, x, y);
    add(f, f, x);
    mul(f, w, f);
    add(x, apb, qd);
    times3(x, x);
    add(f, f, f);
    sub(f, x, f);
    times9(x, qd);
    times3(y, apb);
    sub(x, x, y);
    ld1(y, q.sel, Q_C, i, E);
    mul(x, y, x);
    add(x, x, f);
    add_scaled(s, x, QC_LOGIC_K4, cst);
  }
  close_family(t, s, q, Q_LOGIC, QC_LOGIC_SEP, i, cst);
}

// fam += fixed base: a, b = acc_x, acc_y; c = xy_alpha; d = accumulated
// bit; q_l, q_r, q_c = x_beta, y_beta, xy_beta  [19]
__device__ __forceinline__ void fixed_base(Fe& t, const QuotientIn& q,
                                           int64_t i, const uint32_t* cst) {
  const int64_t E = q.E;
  Fe xa, ya, s, x, y;
  {
    Fe bit, b2;
    ld_next(x, q, EV_D, HALO_D, i);
    ld(y, q.evs, EV_D, i, E);
    add(y, y, y);
    sub(bit, x, y);
    mul(b2, bit, bit);
    kc(y, cst, QC_ONE);
    sub(x, b2, y);
    mul(s, bit, x);                     // bit (bit - 1)(bit + 1)
    ld1(x, q.sel, Q_R, i, E);
    sub(x, x, y);
    mul(x, b2, x);
    add(ya, x, y);                      // bit^2 (y_beta - 1) + 1
    ld1(x, q.sel, Q_L, i, E);
    mul(xa, x, bit);                    // x_beta bit
    ld1(x, q.sel, Q_C, i, E);
    mul(x, bit, x);
    ld(y, q.evs, EV_C, i, E);
    sub(x, x, y);
    add_scaled(s, x, QC_FIXED_K1, cst);
  }
  Fe a, b, kd;
  ld(a, q.evs, EV_A, i, E);
  ld(b, q.evs, EV_B, i, E);
  ld(y, q.evs, EV_C, i, E);
  mul(kd, y, a);
  mul(kd, kd, b);
  kc(y, cst, QC_JUBJUB_D);
  mul(kd, kd, y);                       // xy_alpha acc_x acc_y d
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

// fam += variable base: (x1, y1, x2, y2) = (a, b, c, d), (x3, y3, x1 y2) =
// (a', b', d')  [12]
__device__ __forceinline__ void variable_base(Fe& t, const QuotientIn& q,
                                              int64_t i,
                                              const uint32_t* cst) {
  const int64_t E = q.E;
  Fe a, b, g, s, x, y;
  ld(a, q.evs, EV_A, i, E);
  ld(y, q.evs, EV_D, i, E);
  mul(s, a, y);
  ld_next(x, q, EV_D, HALO_D, i);       // x1 y2 at the next gate
  sub(s, s, x);
  ld(b, q.evs, EV_B, i, E);
  ld(y, q.evs, EV_C, i, E);
  mul(y, b, y);                         // y1 x2
  kc(g, cst, QC_JUBJUB_D);
  mul(g, g, x);
  mul(g, g, y);                         // d x1y2 y1x2
  add(x, x, y);
  {
    Fe e;
    ld_next(y, q, EV_A, HALO_A, i);
    mul(e, y, g);
    add(y, y, e);
    sub(x, x, y);
    add_scaled(s, x, QC_VAR_K1, cst);
    ld(x, q.evs, EV_D, i, E);
    mul(x, b, x);
    ld(y, q.evs, EV_C, i, E);
    mul(y, a, y);
    add(x, x, y);
    ld_next(y, q, EV_B, HALO_B, i);
    mul(e, y, g);
    sub(y, y, e);
    sub(x, x, y);
    add_scaled(s, x, QC_VAR_K2, cst);
  }
  close_family(t, s, q, Q_VAR, QC_VAR_SEP, i, cst);
}

// perm += P1 z, P1 the identity wires' product
// (a + beta X + gamma)(b + k1 beta X + gamma)(c + ..)(d + ..), with
// k1, k2, k3 = 7, 13, 17 (fields/constants.py's PERM_K1..3) as adds  [5]
__device__ __forceinline__ void perm_identity(Fe& p, const QuotientIn& q,
                                              int64_t i,
                                              const uint32_t* cst) {
  const int64_t E = q.E;
  Fe bx, s, x, y;
  kc(y, cst, QC_BETA);
  ld1(x, q.lin, 0, i, E);
  mul(bx, y, x);                        // beta X
  ld(s, q.evs, EV_A, i, E);
  add(s, s, bx);
  kc(y, cst, QC_GAMMA);
  add(s, s, y);
  {
    Fe b4, b8;
    add(b4, bx, bx);
    add(b4, b4, b4);
    add(b8, b4, b4);
    sub(x, b8, bx);                     // 7 beta X
    ld(y, q.evs, EV_B, i, E);
    add(x, y, x);
    kc(y, cst, QC_GAMMA);
    add(x, x, y);
    mul(s, s, x);
    add(x, b8, b4);
    add(x, x, bx);                      // 13 beta X
    ld(y, q.evs, EV_C, i, E);
    add(x, y, x);
    kc(y, cst, QC_GAMMA);
    add(x, x, y);
    mul(s, s, x);
    add(x, b8, b8);
    add(x, x, bx);                      // 17 beta X
  }
  ld(y, q.evs, EV_D, i, E);
  add(x, y, x);
  kc(y, cst, QC_GAMMA);
  add(x, x, y);
  mul(s, s, x);
  ld(x, q.evs, EV_Z, i, E);
  mul(s, s, x);
  add(p, p, s);
}

// perm -= P2 z', P2 the sigma wires' product
// (a + beta s1 + gamma)(b + beta s2 + gamma)(c + ..)(d + ..)  [8]
__device__ __forceinline__ void perm_sigma(Fe& p, const QuotientIn& q,
                                           int64_t i, const uint32_t* cst) {
  const int64_t E = q.E;
  Fe g, x, y;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    kc(y, cst, QC_BETA);
    ld1(x, q.sig, k, i, E);
    mul(x, y, x);
    ld(y, q.evs, EV_A + k, i, E);
    add(x, y, x);
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
  sub(p, p, g);
}

// perm += alpha (z - 1) L1  [2]
__device__ __forceinline__ void perm_l1(Fe& p, const QuotientIn& q,
                                        int64_t i, const uint32_t* cst) {
  const int64_t E = q.E;
  Fe x, y;
  ld(x, q.evs, EV_Z, i, E);
  kc(y, cst, QC_ONE);
  sub(x, x, y);
  ld1(y, q.l1, 0, i, E);
  mul(x, x, y);
  kc(y, cst, QC_ALPHA);
  mul(x, x, y);
  add(p, p, x);
}

// -- the groups and the combine --------------------------------------------

// Group g's terms at point i, added into fam and perm (both zero before).
// The last group also runs the combine, which starts when the slowest
// group is done.  Multiplies a group: 23, 22, 20, 19 (21 with the
// combine).  tools/kernel_variants/quotient_variants.py times a split into
// three groups too (30, 27, 27 + 2; its probe `g3`).
__device__ __forceinline__ void group_terms(int g, Fe& fam, Fe& perm,
                                            const QuotientIn& q, int64_t i,
                                            const uint32_t* cst) {
  if (g == 0) {
    logic(fam, q, i, cst);
    perm_identity(perm, q, i, cst);
  } else if (g == 1) {
    range(fam, q, i, cst);
    arithmetic(fam, q, i);
    perm_l1(perm, q, i, cst);
  } else if (g == 2) {
    variable_base(fam, q, i, cst);
    perm_sigma(perm, q, i, cst);
  } else {
    fixed_base(fam, q, i, cst);
  }
}

// t = (fam + alpha perm) vh_inv, fam and perm summed over the groups  [2]
__device__ __forceinline__ void combine(Fe& t, const Fe& fam,
                                        const Fe& perm, const QuotientIn& q,
                                        int64_t i, const uint32_t* cst) {
  Fe x, y;
  kc(y, cst, QC_ALPHA);
  mul(x, perm, y);
  add(x, fam, x);
  ld1(y, q.vh_inv, 0, i, q.E);
  mul(t, x, y);
}

}  // namespace q14
