"""Kernel K14's arithmetic (dusk_plonk_torch/csrc/quotient.cuh, the
per-point function the CUDA kernel runs) on the CPU: g++ builds it over the
host model of the PTX carry flag of test_torch_fq_carry_model.py, and its
grid is held limb for limb against the plain version (ops/kernels.py::
quotient_plain) on seeded random inputs, the wraparound halo included: on
one device (E = 64) and on two shards of 32 whose halos come from
M.next_halo.  The CUDA kernel itself runs on the card in chip_smoke.py."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_fq_carry_model import PTX_MODEL
from test_torch_quotient import make_inputs

from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.parallel import mesh as M

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dusk_plonk_torch", "csrc")

# argv: input file (E, C as int64, then the arrays as uint32, in
# dt_quotient's order), output file ((16, E) uint32); the table goes to
# words as quotient_kernel's prologue builds it
MAIN = r"""
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#include <cstdio>
#include <vector>
#include "quotient.cuh"
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
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
  std::vector<uint32_t> out(16 * E);
  for (int64_t i = 0; i < E; i++) {
    uint32_t t[8];
    q14::quotient_element(t, q, i, cst);
    store_limbs<8>(out.data() + i, E, t);
  }
  FILE* g = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), g);
  fclose(g);
  return 0;
}
"""


@pytest.fixture(scope="module")
def model(tmp_path_factory):
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
    exe, d = model
    E = args[0].shape[-1]
    inp, out = d / f"in{E}.bin", d / f"out{E}.bin"
    with open(inp, "wb") as f:
        f.write(np.array([E, args[-1].shape[-1]], np.int64).tobytes())
        for t in args:
            f.write(t.numpy().astype(np.uint32).tobytes())
    res = subprocess.run([str(exe), str(inp), str(out)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    return torch.from_numpy(np.fromfile(out, np.uint32).astype(np.int32)
                            .reshape(16, E))


@pytest.mark.parametrize("seed", [14, 15])
def test_quotient_model_equals_plain_one_device(model, seed):
    inputs, ch = make_inputs(64, seed)
    t = {k: x for k, (_, x) in inputs.items()}
    args = (t["evs"], t["evs"][[0, 1, 2, 4], :, :8].contiguous(), t["sel8"],
            t["sig8"], t["l1_8"], t["lin8"], t["vh_inv8"],
            kernels.quotient_consts(fr_field(), ch, "cpu"))
    assert torch.equal(run_model(model, args),
                       kernels.quotient_plain(fr_field(), *args))


def test_quotient_model_equals_plain_two_shards(model):
    inputs, ch = make_inputs(64, 16)
    mesh = M.Mesh(["cpu"] * 2)
    sh = {k: M.shard(mesh, x) for k, (_, x) in inputs.items()}
    halos = M.next_halo(mesh, [e[[0, 1, 2, 4], :, :8].contiguous()
                               for e in sh["evs"]], 8)
    consts = kernels.quotient_consts(fr_field(), ch, "cpu")
    for j in range(2):
        args = (sh["evs"][j], halos[j].contiguous(), sh["sel8"][j],
                sh["sig8"][j], sh["l1_8"][j], sh["lin8"][j],
                sh["vh_inv8"][j], consts)
        assert torch.equal(run_model(model, args),
                           kernels.quotient_plain(fr_field(), *args))
