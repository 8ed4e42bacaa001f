// Complete G1 addition on BLS12-381 (y^2 = x^3 + 4), Renes-Costello-Batina
// 2015 algorithm 7 (a = 0), and its doubling, algorithm 9, over Fq in
// Montgomery form (field.cuh).
//
// The formula order follows dusk_plonk_tpu/ops/ec.py::DeviceG1._add_xla and
// _add_mixed_xla (ec.py:120-199) step for step, and the multiply by
// b3 = 12 is the same chain of four modular adds (_mul12).  Every step
// returns a canonical value, so the projective (X, Y, Z) this code returns
// is the JAX package's, limb for limb.  Identity = (0, 1, 0).
#pragma once

#include "field.cuh"

typedef uint32_t Fq[12];

__device__ __forceinline__ void fq_mul(Fq& r, const Fq& a, const Fq& b) {
  mont_mul<12>(r, a, b);
}
__device__ __forceinline__ void fq_add(Fq& r, const Fq& a, const Fq& b) {
  add_mod<12>(r, a, b);
}
__device__ __forceinline__ void fq_sub(Fq& r, const Fq& a, const Fq& b) {
  sub_mod<12>(r, a, b);
}

// 12 x = 8x + 4x via 4 modular adds (ec.py::DeviceG1._mul12)
__device__ __forceinline__ void fq_mul12(Fq& r, const Fq& x) {
  Fq x2, x4, x8;
  fq_add(x2, x, x);
  fq_add(x4, x2, x2);
  fq_add(x8, x4, x4);
  fq_add(r, x8, x4);
}

struct G1Proj {
  Fq x, y, z;
};

__device__ __forceinline__ void g1_set_identity(G1Proj& p) {
  const uint32_t one[12] = FQ_ONE_WORDS;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    p.x[i] = 0;
    p.y[i] = one[i];
    p.z[i] = 0;
  }
}

// r = p + q, complete projective addition (ec.py:120-149).  r may alias p.
__device__ __forceinline__ void g1_add(G1Proj& r, const G1Proj& p,
                                       const G1Proj& q) {
  Fq t0, t1, t2, t3, t4, x3, y3, z3, u, v;
  fq_mul(t0, p.x, q.x);
  fq_mul(t1, p.y, q.y);
  fq_mul(t2, p.z, q.z);
  fq_add(u, p.x, p.y);
  fq_add(v, q.x, q.y);
  fq_mul(t3, u, v);
  fq_add(u, t0, t1);
  fq_sub(t3, t3, u);               // x1y2 + x2y1
  fq_add(u, p.y, p.z);
  fq_add(v, q.y, q.z);
  fq_mul(t4, u, v);
  fq_add(u, t1, t2);
  fq_sub(t4, t4, u);               // y1z2 + y2z1
  fq_add(u, p.x, p.z);
  fq_add(v, q.x, q.z);
  fq_mul(x3, u, v);
  fq_add(u, t0, t2);
  fq_sub(y3, x3, u);               // x1z2 + x2z1
  fq_add(x3, t0, t0);
  fq_add(t0, x3, t0);              // 3 x1x2
  fq_mul12(t2, t2);                // b3 z1z2
  fq_add(z3, t1, t2);
  fq_sub(t1, t1, t2);
  fq_mul12(y3, y3);                // b3 (x1z2 + x2z1)
  fq_mul(x3, t4, y3);
  fq_mul(t2, t3, t1);
  fq_sub(x3, t2, x3);
  fq_mul(y3, y3, t0);
  fq_mul(t1, t1, z3);
  fq_add(y3, t1, y3);
  fq_mul(t0, t0, t3);
  fq_mul(z3, z3, t4);
  fq_add(z3, z3, t0);
#pragma unroll
  for (int i = 0; i < 12; i++) {
    r.x[i] = x3[i];
    r.y[i] = y3[i];
    r.z[i] = z3[i];
  }
}

// r = 2p, Renes-Costello-Batina 2015 algorithm 9 (a = 0, b3 = 12 through
// fq_mul12): 8 multiplies against g1_add's 12, in the step order of
// ec.py::DeviceG1.double_formula.  Complete: the identity (0, 1, 0) maps to
// itself.  r may alias p.
__device__ __forceinline__ void g1_dbl(G1Proj& r, const G1Proj& p) {
  Fq t0, t1, t2, x3, y3, z3;
  fq_mul(t0, p.y, p.y);
  fq_add(z3, t0, t0);
  fq_add(z3, z3, z3);
  fq_add(z3, z3, z3);              // 8 y^2
  fq_mul(t1, p.y, p.z);
  fq_mul(t2, p.z, p.z);
  fq_mul12(t2, t2);                // b3 z^2
  fq_mul(x3, t2, z3);
  fq_add(y3, t0, t2);
  fq_mul(z3, t1, z3);
  fq_add(t1, t2, t2);
  fq_add(t2, t1, t2);              // 3 b3 z^2
  fq_sub(t0, t0, t2);
  fq_mul(y3, t0, y3);
  fq_add(y3, x3, y3);
  fq_mul(t1, p.x, p.y);
  fq_mul(x3, t0, t1);
  fq_add(x3, x3, x3);
#pragma unroll
  for (int i = 0; i < 12; i++) {
    r.x[i] = x3[i];
    r.y[i] = y3[i];
    r.z[i] = z3[i];
  }
}

// r = p + (x2, y2) with the second operand strictly affine (z2 = 1, never
// the identity): the 11-multiply mixed form (ec.py:173-199).  r may alias p.
__device__ __forceinline__ void g1_add_mixed(G1Proj& r, const G1Proj& p,
                                             const Fq& x2, const Fq& y2) {
  Fq t0, t1, t2, t3, t4, x3, y3, z3, u, v;
  fq_mul(t0, p.x, x2);
  fq_mul(t1, p.y, y2);
  fq_add(u, p.x, p.y);
  fq_add(v, x2, y2);
  fq_mul(t3, u, v);
  fq_add(u, t0, t1);
  fq_sub(t3, t3, u);               // x1y2 + x2y1
  fq_mul(u, y2, p.z);
  fq_add(t4, p.y, u);              // y1 + y2 z1
  fq_mul(u, x2, p.z);
  fq_add(y3, p.x, u);              // x1 + x2 z1
  fq_add(x3, t0, t0);
  fq_add(t0, x3, t0);              // 3 x1x2
  fq_mul12(t2, p.z);               // b3 z1
  fq_add(z3, t1, t2);
  fq_sub(t1, t1, t2);
  fq_mul12(y3, y3);                // b3 (x1 + x2 z1)
  fq_mul(x3, t4, y3);
  fq_mul(t2, t3, t1);
  fq_sub(x3, t2, x3);
  fq_mul(y3, y3, t0);
  fq_mul(t1, t1, z3);
  fq_add(y3, t1, y3);
  fq_mul(t0, t0, t3);
  fq_mul(z3, z3, t4);
  fq_add(z3, z3, t0);
#pragma unroll
  for (int i = 0; i < 12; i++) {
    r.x[i] = x3[i];
    r.y[i] = y3[i];
    r.z[i] = z3[i];
  }
}

// -- team operations -------------------------------------------------------------
//
// A team is T neighbouring threads of one warp (rank 0..T-1) that run one
// doubling, complete add or mixed add together.  Each level of the formula's
// independent multiplies is dealt out one multiply to a thread (in
// ceil(M / T) rounds when the level has M > T), the products meet in the
// team's shared scratch, and the modular adds between the levels run on
// every thread of the team: a warp issues an instruction once whichever
// of its threads run it, so the copies cost no issue slot and no thread
// waits for another's sums.  A doubling (two levels of 4 multiplies), an
// add (two levels of 6) or a mixed add (levels of 5 and 6) then takes two
// dependent multiplies and the adds, against 8, 12 or 11 multiplies on one
// thread.  Every value is the canonical one of g1_dbl / g1_add /
// g1_add_mixed (a Montgomery product is the same whichever operand comes
// first), so the projective result is theirs limb for limb.
//
// Scratch: TEAM_SLOTS Fq slots a team, word-major across the block: word i
// of the team's slot k is s[i * stride + k], where s points at the team's
// first slot and `stride` counts the slots of the block, so the teams of
// a warp touch neighbouring words.  Slots 0-5 take the first level's
// products and 6-11 the second's; with one __syncwarp after each level no
// thread overwrites a slot that another still reads, in this operation or
// the next.  All 32 threads of the warp call every operation together:
// a thread without a lane runs a copy of one and stores nothing.

constexpr int TEAM_SLOTS = 12;

__device__ __forceinline__ void put_slot(uint32_t* s, int stride, int k,
                                         const Fq& v) {
#pragma unroll
  for (int i = 0; i < 12; i++) s[i * stride + k] = v[i];
}

__device__ __forceinline__ void get_slot(Fq& v, const uint32_t* s,
                                         int stride, int k) {
#pragma unroll
  for (int i = 0; i < 12; i++) v[i] = s[i * stride + k];
}

// r = c ? a : b, word by word (r may alias a or b)
__device__ __forceinline__ void fq_sel(Fq& r, bool c, const Fq& a,
                                       const Fq& b) {
#pragma unroll
  for (int i = 0; i < 12; i++) r[i] = c ? a[i] : b[i];
}

// r = 2p on a team of T: g1_dbl's multiplies as two levels of four,
//   level 1 (slots 0-3): y y, y z, z z, x y;
//   level 2 (slots 6-9): 12 z^2 8 y^2, y z 8 y^2,
//                         (y^2 - 36 z^2)(y^2 + 12 z^2), (y^2 - 36 z^2) x y.
// r may alias p.
template <int T>
__device__ __forceinline__ void g1_dbl_team(G1Proj& r, const G1Proj& p,
                                            int rank, uint32_t* s,
                                            int stride) {
#pragma unroll
  for (int j0 = 0; j0 < 4; j0 += T) {
    int j = j0 + rank;               // job; j >= 4 runs a copy, unstored
    Fq a, b, t;
    fq_sel(a, j == 2, p.z, p.y);
    fq_sel(a, j >= 3, p.x, a);
    fq_sel(b, j == 1 || j == 2, p.z, p.y);
    fq_mul(t, a, b);
    if (j < 4) put_slot(s, stride, j, t);
  }
  __syncwarp();
  Fq t0, t1, t2, t3, z3, y3, u;
  get_slot(t0, s, stride, 0);
  get_slot(t1, s, stride, 1);
  get_slot(t2, s, stride, 2);
  get_slot(t3, s, stride, 3);
  fq_add(z3, t0, t0);
  fq_add(z3, z3, z3);
  fq_add(z3, z3, z3);              // 8 y^2
  fq_mul12(t2, t2);                // b3 z^2
  fq_add(y3, t0, t2);
  fq_add(u, t2, t2);
  fq_add(u, u, t2);                // 3 b3 z^2
  fq_sub(t0, t0, u);
#pragma unroll
  for (int j0 = 0; j0 < 4; j0 += T) {
    int j = j0 + rank;
    Fq a, b, t;
    fq_sel(a, j == 1, t1, t0);
    fq_sel(a, j == 0, t2, a);
    fq_sel(b, j == 2, y3, t3);
    fq_sel(b, j <= 1, z3, b);
    fq_mul(t, a, b);
    if (j < 4) put_slot(s, stride, 6 + j, t);
  }
  __syncwarp();
  Fq x3, xy;
  get_slot(x3, s, stride, 6);
  get_slot(r.z, s, stride, 7);
  get_slot(y3, s, stride, 8);
  get_slot(xy, s, stride, 9);
  fq_add(r.y, x3, y3);
  fq_add(r.x, xy, xy);
}

// The second level of g1_add_team and g1_add_mixed_team (RCB15's six
// products t4 y3, t3 t1, y3 t0, t1 z3, t0 t3, z3 t4 in g1_add's names, in
// slots 6-11) and the three sums that finish either formula:
// X3 = t3 t1 - t4 y3, Y3 = t1 z3 + y3 t0, Z3 = z3 t4 + t0 t3.
template <int T>
__device__ __forceinline__ void team_add_level2(
    G1Proj& r, const Fq& t0, const Fq& t1, const Fq& t3, const Fq& t4,
    const Fq& y3, const Fq& z3, int rank, uint32_t* s, int stride) {
#pragma unroll
  for (int j0 = 0; j0 < 6; j0 += T) {
    int j = j0 + rank;               // job; j >= 6 runs a copy, unstored
    // a: t4, t3, y3, t1, t0, z3; b: y3, t1, t0, z3, t3, t4
    Fq a, b, t;
    fq_sel(a, j == 4, t0, z3);
    fq_sel(a, j == 3, t1, a);
    fq_sel(a, j == 2, y3, a);
    fq_sel(a, j == 1, t3, a);
    fq_sel(a, j == 0, t4, a);
    fq_sel(b, j == 4, t3, t4);
    fq_sel(b, j == 3, z3, b);
    fq_sel(b, j == 2, t0, b);
    fq_sel(b, j == 1, t1, b);
    fq_sel(b, j == 0, y3, b);
    fq_mul(t, a, b);
    if (j < 6) put_slot(s, stride, 6 + j, t);
  }
  __syncwarp();
  Fq m0, m1;
  get_slot(m0, s, stride, 6);
  get_slot(m1, s, stride, 7);
  fq_sub(r.x, m1, m0);
  get_slot(m0, s, stride, 8);
  get_slot(m1, s, stride, 9);
  fq_add(r.y, m1, m0);
  get_slot(m0, s, stride, 10);
  get_slot(m1, s, stride, 11);
  fq_add(r.z, m1, m0);
}

// r = p + q on a team of T: g1_add's multiplies as two levels of six,
//   level 1 (slots 0-5): x1 x2, y1 y2, z1 z2, (x1 + y1)(x2 + y2),
//                         (y1 + z1)(y2 + z2), (x1 + z1)(x2 + z2);
//   level 2 (slots 6-11): team_add_level2.
// r may alias p or q.
template <int T>
__device__ __forceinline__ void g1_add_team(G1Proj& r, const G1Proj& p,
                                            const G1Proj& q, int rank,
                                            uint32_t* s, int stride) {
#pragma unroll
  for (int j0 = 0; j0 < 6; j0 += T) {
    int j = j0 + rank;               // job; j >= 6 runs a copy, unstored
    // first coordinate x, y, z, x, y, x; second (jobs 3-5) y, z, z
    bool fy = j == 1 || j == 4, fz = j == 2, sy = j == 3;
    Fq a, b, u, t;
    fq_sel(a, fy, p.y, p.x);
    fq_sel(a, fz, p.z, a);
    fq_sel(u, sy, p.y, p.z);
    fq_add(u, a, u);
    fq_sel(a, j >= 3, u, a);
    fq_sel(b, fy, q.y, q.x);
    fq_sel(b, fz, q.z, b);
    fq_sel(u, sy, q.y, q.z);
    fq_add(u, b, u);
    fq_sel(b, j >= 3, u, b);
    fq_mul(t, a, b);
    if (j < 6) put_slot(s, stride, j, t);
  }
  __syncwarp();
  Fq t0, t1, t2, t3, t4, y3, z3, u;
  get_slot(t0, s, stride, 0);
  get_slot(t1, s, stride, 1);
  get_slot(t2, s, stride, 2);
  get_slot(t3, s, stride, 3);
  get_slot(t4, s, stride, 4);
  get_slot(y3, s, stride, 5);
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
  team_add_level2<T>(r, t0, t1, t3, t4, y3, z3, rank, s, stride);
}

// r = p + (x2, y2) on a team of T, the second operand strictly affine as
// for g1_add_mixed: its 11 multiplies as a level of five and a level of
// six,
//   level 1 (slots 0-4): x1 x2, y1 y2, (x1 + y1)(x2 + y2), z1 y2, z1 x2;
//   level 2 (slots 6-11): team_add_level2,
// so the chain is two dependent multiplies against 11 on one thread.
// r may alias p.
template <int T>
__device__ __forceinline__ void g1_add_mixed_team(G1Proj& r, const G1Proj& p,
                                                  const Fq& x2, const Fq& y2,
                                                  int rank, uint32_t* s,
                                                  int stride) {
#pragma unroll
  for (int j0 = 0; j0 < 5; j0 += T) {
    int j = j0 + rank;               // job; j >= 5 runs a copy, unstored
    // first operand x1, y1, x1 + y1, z1, z1; second x2, y2, x2 + y2, y2, x2
    Fq a, b, u;
    fq_sel(a, j == 1, p.y, p.x);
    fq_sel(a, j >= 3, p.z, a);
    fq_add(u, p.x, p.y);
    fq_sel(a, j == 2, u, a);
    fq_sel(b, j == 1 || j == 3, y2, x2);
    fq_add(u, x2, y2);
    fq_sel(b, j == 2, u, b);
    fq_mul(u, a, b);
    if (j < 5) put_slot(s, stride, j, u);
  }
  __syncwarp();
  Fq t0, t1, t2, t3, t4, y3, z3, u;
  get_slot(t0, s, stride, 0);
  get_slot(t1, s, stride, 1);
  get_slot(t3, s, stride, 2);
  get_slot(t4, s, stride, 3);
  get_slot(y3, s, stride, 4);
  fq_add(u, t0, t1);
  fq_sub(t3, t3, u);               // x1y2 + x2y1
  fq_add(t4, p.y, t4);             // y1 + y2 z1
  fq_add(y3, p.x, y3);             // x1 + x2 z1
  fq_add(u, t0, t0);
  fq_add(t0, u, t0);               // 3 x1x2
  fq_mul12(t2, p.z);               // b3 z1
  fq_add(z3, t1, t2);
  fq_sub(t1, t1, t2);
  fq_mul12(y3, y3);                // b3 (x1 + x2 z1)
  team_add_level2<T>(r, t0, t1, t3, t4, y3, z3, rank, s, stride);
}

// -- points in limb planes and in shared memory ---------------------------------

// a block's T shared point slots: word w of slot r sits at tot[w * T + r],
// so a warp's accesses to one word of neighbouring slots hit 32 banks
__device__ __forceinline__ void put_point(uint32_t* tot, int T, int r,
                                          const G1Proj& p) {
#pragma unroll
  for (int i = 0; i < 12; i++) {
    tot[i * T + r] = p.x[i];
    tot[(12 + i) * T + r] = p.y[i];
    tot[(24 + i) * T + r] = p.z[i];
  }
}

__device__ __forceinline__ void get_point(G1Proj& p, const uint32_t* tot,
                                          int T, int r) {
#pragma unroll
  for (int i = 0; i < 12; i++) {
    p.x[i] = tot[i * T + r];
    p.y[i] = tot[(12 + i) * T + r];
    p.z[i] = tot[(24 + i) * T + r];
  }
}

__device__ __forceinline__ void load_point(G1Proj& p, const uint32_t* gx,
                                           const uint32_t* gy,
                                           const uint32_t* gz, int64_t off,
                                           int64_t lanes) {
  load_limbs<12>(p.x, gx + off, lanes);
  load_limbs<12>(p.y, gy + off, lanes);
  load_limbs<12>(p.z, gz + off, lanes);
}
