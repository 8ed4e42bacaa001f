"""Kernel K14's arithmetic (dusk_plonk_torch/csrc/quotient.cuh, the
functions the CUDA kernel's warps run) on the CPU: g++ builds them over the
host model of the PTX carry flag of test_torch_fq_carry_model.py.  Each
gate family's term and each family group's two sums are held limb for limb
against the matching widget of proving/widgets.py run through
quotient_plain's _TableOps, and the grid, summed and combined as
quotient.cu sums and combines it, against the plain version
(ops/kernels.py::quotient_plain), on seeded random inputs, the wraparound
halo included: on one device (E = 64; 8, 40 and 100 for the grid) and
on two shards of 32 whose halos come from M.next_halo.  Fr's shaped
multiply (fr_mont_mul) is held against Python integers and field.cuh's
mont_mul<8>, on rows whose low word cancels too.  The CUDA kernel itself
runs on the card in chip_smoke.py."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_fq_carry_model import PTX_MODEL
from test_torch_quotient import make_inputs

from dusk_plonk_torch.fields.constants import (PERM_K1, PERM_K2, PERM_K3,
                                                R_MOD)
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.proving import widgets
from dusk_plonk_torch.proving.keys import SELECTOR_NAMES

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dusk_plonk_torch", "csrc")

# quotient.cuh's families in the order the model writes them, and its
# split into Q14_GROUPS groups (group_terms)
FAMILIES = ("arithmetic", "range", "logic", "fixed_base", "variable_base",
            "perm_identity", "perm_sigma", "perm_l1")
PERM_PARTS = ("perm_identity", "perm_sigma", "perm_l1")
SPLIT = (("logic", "perm_identity"),
         ("range", "arithmetic", "perm_l1"),
         ("variable_base", "perm_sigma"),
         ("fixed_base",))

# `model grid IN OUT`: IN holds E, C as int64, then the arrays as uint32 in
# dt_quotient's order; OUT gets, as (16, E) uint32 planes, each family's
# term alone, each group's fam and perm, and the grid, the groups' sums
# met and combined as quotient_groups_kernel does.  The table goes to words
# as the kernel's prologue builds it.  `model mul`: "a b" pairs of 8 hex
# words on stdin, "fr_mont_mul mont_mul<8>" for each on stdout.
MAIN = r"""
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#include <cstdio>
#include <cstring>
#include <vector>
#include "quotient.cuh"
using q14::Fe;
static int mul_mode() {
  uint32_t a[8], b[8], r[8];
  while (true) {
    for (int i = 0; i < 8; i++) if (scanf("%x", &a[i]) != 1) return 0;
    for (int i = 0; i < 8; i++) if (scanf("%x", &b[i]) != 1) return 1;
    fr_mont_mul(r, a, b);
    for (int i = 0; i < 8; i++) printf("%x ", r[i]);
    mont_mul<8>(r, a, b);
    for (int i = 0; i < 8; i++) printf("%x ", r[i]);
    printf("\n");
  }
}
int main(int argc, char** argv) {
  if (strcmp(argv[1], "mul") == 0) return mul_mode();
  FILE* f = fopen(argv[2], "rb");
  int64_t E, C;
  if (fread(&E, 8, 1, f) != 1 || fread(&C, 8, 1, f) != 1) return 4;
  if (C != QC_COLUMNS) return 5;
  auto rd = [&](size_t n) {
    std::vector<uint32_t> v(n);
    if (fread(v.data(), 4, n, f) != n) exit(6);
    return v;
  };
  auto evs = rd(6 * 16 * E), halo = rd(4 * 16 * 8), sel = rd(11 * 16 * E),
       sig = rd(4 * 16 * E), l1 = rd(16 * E), lin = rd(16 * E),
       vh = rd(16 * E), consts = rd(16 * C);
  uint32_t cst[QC_COLUMNS * 8];
  for (int k = 0; k < QC_COLUMNS * 8; k++) {
    int col = k >> 3, w = k & 7;
    cst[k] = (consts[(2 * w) * QC_COLUMNS + col] & 0xffffu) |
             (consts[(2 * w + 1) * QC_COLUMNS + col] << 16);
  }
  QuotientIn q{evs.data(), halo.data(), sel.data(), sig.data(), l1.data(),
               lin.data(), vh.data(), E};
  const int planes = 8 + 2 * Q14_GROUPS + 1;
  std::vector<uint32_t> out(planes * 16 * E);
  auto put = [&](int plane, int64_t i, const Fe& v) {
    store_limbs<8>(out.data() + plane * 16 * E + i, E, v);
  };
  for (int64_t i = 0; i < E; i++) {
    for (int k = 0; k < 8; k++) {
      Fe x = {0};
      if (k == 0) q14::arithmetic(x, q, i);
      if (k == 1) q14::range(x, q, i, cst);
      if (k == 2) q14::logic(x, q, i, cst);
      if (k == 3) q14::fixed_base(x, q, i, cst);
      if (k == 4) q14::variable_base(x, q, i, cst);
      if (k == 5) q14::perm_identity(x, q, i, cst);
      if (k == 6) q14::perm_sigma(x, q, i, cst);
      if (k == 7) q14::perm_l1(x, q, i, cst);
      put(k, i, x);
    }
    Fe fam[Q14_GROUPS], perm[Q14_GROUPS];
    for (int g = 0; g < Q14_GROUPS; g++) {
      for (int k = 0; k < 8; k++) fam[g][k] = perm[g][k] = 0;
      q14::group_terms(g, fam[g], perm[g], q, i, cst);
      put(8 + 2 * g, i, fam[g]);
      put(9 + 2 * g, i, perm[g]);
    }
    const int last = Q14_GROUPS - 1;
    for (int h = 0; h < last; h++) {
      q14::add(fam[last], fam[last], fam[h]);
      q14::add(perm[last], perm[last], perm[h]);
    }
    Fe t;
    q14::combine(t, fam[last], perm[last], q, i, cst);
    put(planes - 1, i, t);
  }
  FILE* g = fopen(argv[3], "wb");
  fwrite(out.data(), 4, out.size(), g);
  fclose(g);
  return 0;
}
"""


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(exe, dir): the host model of quotient.cuh."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the host model of quotient.cuh")
    d = tmp_path_factory.mktemp("quotient_model")
    for name in ("field.cuh", "quotient.cuh"):
        shutil.copy(os.path.join(CSRC, name), d)
    (d / "ptx.cuh").write_text(PTX_MODEL)
    (d / "cuda_runtime.h").write_text("#pragma once\n")
    (d / "main.cpp").write_text(MAIN)
    exe = d / "model"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", str(d), "-o", str(exe),
                    str(d / "main.cpp")], check=True)
    return exe, d


def run_model(model, args):
    """{name: (16, E) int32 limbs} for each family in FAMILIES, each
    group's ("fam", g) and ("perm", g), and "grid"."""
    exe, d = model
    E = args[0].shape[-1]
    inp, out = d / f"in{E}.bin", d / f"out{E}.bin"
    with open(inp, "wb") as f:
        f.write(np.array([E, args[-1].shape[-1]], np.int64).tobytes())
        for t in args:
            f.write(t.numpy().astype(np.uint32).tobytes())
    res = subprocess.run([str(exe), "grid", str(inp), str(out)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    planes = torch.from_numpy(np.fromfile(out, np.uint32).astype(np.int32)
                              .reshape(-1, 16, E))
    names = list(FAMILIES) + [(s, g) for g in range(len(SPLIT))
                              for s in ("fam", "perm")] + ["grid"]
    assert planes.shape[0] == len(names)
    return dict(zip(names, planes))


def one_device_args(seed, E=64):
    inputs, ch = make_inputs(E, seed)
    t = {k: x for k, (_, x) in inputs.items()}
    return (t["evs"], t["evs"][[0, 1, 2, 4], :, :8].contiguous(), t["sel8"],
            t["sig8"], t["l1_8"], t["lin8"], t["vh_inv8"],
            kernels.quotient_consts(fr_field(), ch, "cpu"))


def two_shard_args(seed):
    inputs, ch = make_inputs(64, seed)
    mesh = M.Mesh(["cpu"] * 2)
    sh = {k: M.shard(mesh, x) for k, (_, x) in inputs.items()}
    halos = M.next_halo(mesh, [e[[0, 1, 2, 4], :, :8].contiguous()
                               for e in sh["evs"]], 8)
    consts = kernels.quotient_consts(fr_field(), ch, "cpu")
    return [(sh["evs"][j], halos[j].contiguous(), sh["sel8"][j],
             sh["sig8"][j], sh["l1_8"][j], sh["lin8"][j], sh["vh_inv8"][j],
             consts) for j in range(2)]


def widget_terms(args):
    """Each family's term as proving/widgets.py computes it through
    quotient_plain's _TableOps (K1's plain multiply), and the
    permutation's three parts from permutation_quotient with the other
    parts' inputs at zero: alpha P1 z (z' = 0, L1 = 0), -alpha P2 z'
    (z = 0), alpha^2 (z - 1) L1 (the difference L1 makes)."""
    F = fr_field()
    evs, halo, sel8, sig8, l1_8, lin8, _, consts = args
    ch = {key: consts[:, j:j + 1]
          for j, key in enumerate(kernels.QUOTIENT_TABLE)}
    ops = kernels._TableOps(F, F.mul_plain, ch)
    z8, a8, b8, c8, d8, pi8 = evs
    z_n, a_n, b_n, d_n = torch.cat([evs[[0, 1, 2, 4], :, 8:], halo], dim=-1)
    s = dict(zip(SELECTOR_NAMES, sel8))
    zero = torch.zeros_like(z8)

    def perm(z, z_next, l1_alpha_sq):
        return widgets.permutation_quotient(
            ops, lin8, *sig8, a8, b8, c8, d8, z, z_next, ch["alpha"],
            l1_alpha_sq, ch["beta"], ch["gamma"])

    return {
        "arithmetic": F.add(widgets.arithmetic_quotient(
            ops, s["q_m"], s["q_l"], s["q_r"], s["q_o"], s["q_c"], s["q_4"],
            s["q_arith"], a8, b8, c8, d8), pi8),
        "range": widgets.range_quotient(
            ops, s["q_range"], ch["range_sep"], a8, b8, c8, d8, d_n),
        "logic": widgets.logic_quotient(
            ops, s["q_logic"], s["q_c"], ch["logic_sep"],
            a8, a_n, b8, b_n, c8, d8, d_n),
        "fixed_base": widgets.fixed_base_quotient(
            ops, s["q_fixed_group_add"], s["q_l"], s["q_r"], s["q_c"],
            ch["fixed_base_sep"], a8, a_n, b8, b_n, c8, d8, d_n),
        "variable_base": widgets.variable_base_quotient(
            ops, s["q_variable_group_add"], ch["var_base_sep"],
            a8, a_n, b8, b_n, c8, d8, d_n),
        "perm_identity": perm(z8, zero, zero),
        "perm_sigma": perm(zero, z_n, zero),
        "perm_l1": F.sub(perm(z8, zero, ops.mul(l1_8, ch["alpha_sq"])),
                         perm(z8, zero, zero)),
    }


def all_args():
    """One device (seed 14) and each of two shards (seed 16)."""
    return [one_device_args(14)] + two_shard_args(16)


@pytest.fixture(scope="module")
def widget_cases():
    """(args, the widgets' terms) for each of all_args()."""
    return [(args, widget_terms(args)) for args in all_args()]


def _alpha(args, x):
    """alpha x: the combine's scaling of a perm sum."""
    alpha = args[-1][:, kernels.QUOTIENT_TABLE.index("alpha"), None]
    return fr_field().mul_plain(x, alpha)


@pytest.mark.parametrize("seed", [14, 15])
def test_quotient_model_equals_plain_one_device(model, seed):
    args = one_device_args(seed)
    assert torch.equal(run_model(model, args)["grid"],
                       kernels.quotient_plain(fr_field(), *args))


@pytest.mark.parametrize("E", [8, 40, 100])
def test_quotient_model_equals_plain_short_and_ragged(model, E):
    """E = 8 (every next gate read from the halo) and E = 40 and 100 (no
    multiple of the kernel's 32 points a block, the halo met inside the
    last block): the grid equals the plain version."""
    args = one_device_args(17, E)
    assert torch.equal(run_model(model, args)["grid"],
                       kernels.quotient_plain(fr_field(), *args))


def test_quotient_model_equals_plain_two_shards(model):
    for args in two_shard_args(16):
        assert torch.equal(run_model(model, args)["grid"],
                           kernels.quotient_plain(fr_field(), *args))


@pytest.mark.parametrize("family", FAMILIES)
def test_family_term_equals_its_widget(model, widget_cases, family):
    """Each family function alone, from a zero sum: its term (a
    permutation part times alpha) equals the widget's, limb for limb."""
    for args, want in widget_cases:
        term = run_model(model, args)[family]
        if family in PERM_PARTS:
            term = _alpha(args, term)
        assert torch.equal(term, want[family]), family


@pytest.mark.parametrize("g", range(len(SPLIT)))
def test_group_sums_equal_widgets(model, widget_cases, g):
    """group_terms(g): its fam sum equals the sum of its families'
    widgets, and alpha times its perm sum the sum of its permutation
    parts' widgets."""
    F = fr_field()
    for args, want in widget_cases:
        got = run_model(model, args)
        fam = perm = torch.zeros_like(got["grid"])
        for name in SPLIT[g]:
            if name in PERM_PARTS:
                perm = F.add(perm, want[name])
            else:
                fam = F.add(fam, want[name])
        assert torch.equal(got[("fam", g)], fam)
        assert torch.equal(_alpha(args, got[("perm", g)]), perm)


def test_add_chain_constants_are_the_permutations():
    """quotient.cuh::perm_identity multiplies beta X by the permutation's
    coset constants with add chains, not through the table's PERM_K
    columns: the constants the chains compute (stated beside them) are
    fields/constants.py's."""
    with open(os.path.join(CSRC, "quotient.cuh")) as f:
        text = f.read()
    stated = re.search(r"k1, k2, k3 = (\d+), (\d+), (\d+)", text)
    assert stated, "quotient.cuh no longer states perm_identity's constants"
    ks = (PERM_K1, PERM_K2, PERM_K3)
    assert ks == tuple(map(int, stated.groups())) and all(
        f"// {k} beta X" in text for k in ks), (
        "fields/constants.py's PERM_K1..3 differ from the add chains of "
        "quotient.cuh::perm_identity (b4, b8): change the chains with them")


def _cancelling_b(a, rows):
    """A b < r whose first `rows` CIOS rows on a (a's low word odd) each
    start with a low word of 0, so that m = 0 there: bi = -V a0^-1 mod
    2^32 from the accumulator V of the row before."""
    a0, mask, V, words = a & 0xFFFFFFFF, (1 << 32) - 1, 0, []
    for _ in range(rows):
        bi = (-V * pow(a0, -1, 1 << 32)) & mask
        words.append(bi)
        V = (V + a * bi) >> 32          # m = 0: no multiple of r
    b = sum(w << (32 * k) for k, w in enumerate(words))
    return b % R_MOD


def test_fr_mont_mul_equals_mont_mul_and_python(model):
    """fr_mont_mul (Fr's shaped multiply, the one the kernel runs) equals
    field.cuh's mont_mul<8> and a b R^-1 mod r, on edge values, random
    pairs and pairs whose rows cancel to a low word of 0 (m = 0, the
    borrow c = 0), under the carry model's checks."""
    exe = model[0]
    rng = np.random.default_rng(12)
    R = 1 << 256
    edge = [0, 1, 2, R_MOD - 1, R_MOD - 2, R % R_MOD, R * R % R_MOD,
            R_MOD >> 1, (R_MOD >> 1) + 1, 1 << 32, (1 << 64) - 1]
    rand = [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(600)]
    pairs = [(a, b) for a in edge for b in edge]
    pairs += list(zip(rand[:300], rand[300:]))
    odd = [a | 1 for a in rand[:40]]
    pairs += [(a, _cancelling_b(a, rows)) for a in odd for rows in (1, 4, 7)]
    text = "\n".join(" ".join(f"{(x >> (32 * k)) & 0xFFFFFFFF:x}"
                              for x in (a, b) for k in range(8))
                     for a, b in pairs)
    res = subprocess.run([str(exe), "mul"], input=text, capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    rinv = pow(R, -1, R_MOD)
    lines = res.stdout.split("\n")[:-1]
    assert len(lines) == len(pairs)
    for (a, b), ln in zip(pairs, lines):
        w = ln.split()
        fr = sum(int(x, 16) << (32 * k) for k, x in enumerate(w[:8]))
        gen = sum(int(x, 16) << (32 * k) for k, x in enumerate(w[8:]))
        assert fr == gen == a * b * rinv % R_MOD, (hex(a), hex(b))
