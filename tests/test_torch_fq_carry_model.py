"""The Fq arithmetic of dusk_plonk_torch/csrc/field.cuh (carry-flag chains:
mont_mul<12>, add_mod<12>, sub_mod<12>) on the CPU.  csrc/ptx.cuh's PTX
primitives are replaced by a host model of the carry flag; the rest of
field.cuh compiles as it is with g++, and its results are held against
Python integers on seeded inputs (random, 0, 1, q - 1 and their
neighbours).  The model also fails on a carry flag read before it is set
and on a carry of 1 that a new chain would drop.  The same sources run on
the card in chip_smoke.py, where every EC kernel is held against its plain
version."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from dusk_plonk_torch.fields.constants import Q_MOD

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dusk_plonk_torch", "csrc")

# CF holds 0 or 1 after a .cc instruction and UNSET after an instruction
# that only reads it
PTX_MODEL = r"""
#pragma once
#include <cstdint>
#include <cstdio>
#include <cstdlib>
static const uint32_t UNSET = 2;
static uint32_t CF = UNSET;
static void fail(const char* m) { fprintf(stderr, "%s\n", m); exit(3); }
static uint32_t cf_in() { if (CF == UNSET) fail("flag read unset"); return CF; }
static void cf_new() { if (CF == 1) fail("carry dropped"); }
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  cf_new(); uint64_t t = (uint64_t)a + b; CF = t >> 32; return (uint32_t)t; }
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint64_t t = (uint64_t)a + b + cf_in(); CF = t >> 32; return (uint32_t)t; }
inline uint32_t addc(uint32_t a, uint32_t b) {
  uint64_t t = (uint64_t)a + b + cf_in(); CF = UNSET; return (uint32_t)t; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  cf_new(); CF = a < b; return a - b; }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)b + cf_in(); CF = a < s;
  return (uint32_t)((uint64_t)a - s); }
inline uint32_t subc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)b + cf_in(); CF = UNSET;
  return (uint32_t)((uint64_t)a - s); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  cf_new(); uint64_t t = (uint64_t)(uint32_t)((uint64_t)a * b) + c;
  CF = t >> 32; return (uint32_t)t; }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint64_t t = (uint64_t)(uint32_t)((uint64_t)a * b) + c + cf_in();
  CF = t >> 32; return (uint32_t)t; }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint64_t t = (((uint64_t)a * b) >> 32) + c + cf_in();
  CF = t >> 32; return (uint32_t)t; }
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint64_t t = (((uint64_t)a * b) >> 32) + c + cf_in();
  if (t >> 32) fail("madc.hi overflow"); CF = UNSET; return (uint32_t)t; }
inline uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
inline uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32); }
"""

# reads "a b" pairs of 12 hex words (little-endian word order) from stdin,
# prints "mul add sub" for each
MAIN = r"""
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#include <cstdio>
#include "field.cuh"
int main() {
  uint32_t a[12], b[12], r[12];
  while (true) {
    for (int i = 0; i < 12; i++) if (scanf("%x", &a[i]) != 1) return 0;
    for (int i = 0; i < 12; i++) if (scanf("%x", &b[i]) != 1) return 1;
    for (int op = 0; op < 3; op++) {
      if (op == 0) mont_mul<12>(r, a, b);
      if (op == 1) add_mod<12>(r, a, b);
      if (op == 2) sub_mod<12>(r, a, b);
      for (int i = 0; i < 12; i++) printf("%x ", r[i]);
    }
    printf("\n");
  }
}
"""


def _words(x):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(12)]


def _value(words):
    return sum(int(w, 16) << (32 * i) for i, w in enumerate(words))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the host model of field.cuh")
    d = tmp_path_factory.mktemp("fq_model")
    shutil.copy(os.path.join(CSRC, "field.cuh"), d)
    (d / "ptx.cuh").write_text(PTX_MODEL)
    (d / "cuda_runtime.h").write_text("#pragma once\n")
    (d / "main.cpp").write_text(MAIN)
    exe = d / "model"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", str(d), "-o", str(exe),
                    str(d / "main.cpp")], check=True)
    return exe


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, Q_MOD - 1, Q_MOD - 2, (1 << 380) - 1, 1 << 379,
            Q_MOD >> 1, (Q_MOD >> 1) + 1]
    pairs = [(a, b) for a in edge for b in edge]
    pairs += [(int.from_bytes(rng.bytes(48), "little") % Q_MOD,
               int.from_bytes(rng.bytes(48), "little") % Q_MOD)
              for _ in range(n)]
    return pairs


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_fq_carry_chains_match_python_integers(model, op):
    pairs = _inputs(4, 3000)
    text = "\n".join(" ".join(f"{w:x}" for w in _words(a) + _words(b))
                     for a, b in pairs)
    out = subprocess.run([str(model)], input=text, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
    rinv = pow(1 << 384, -1, Q_MOD)
    want = {"mont_mul": lambda a, b: a * b * rinv % Q_MOD,
            "add_mod": lambda a, b: (a + b) % Q_MOD,
            "sub_mod": lambda a, b: (a - b) % Q_MOD}[op]
    col = ["mont_mul", "add_mod", "sub_mod"].index(op)
    lines = out.stdout.split("\n")[:-1]
    assert len(lines) == len(pairs)
    for (a, b), ln in zip(pairs, lines):
        words = ln.split()[12 * col:12 * (col + 1)]
        assert _value(words) == want(a, b), (hex(a), hex(b))
