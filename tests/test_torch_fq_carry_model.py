"""The field arithmetic of dusk_plonk_torch/csrc/field.cuh (carry-flag
chains: mont_mul, add_mod, sub_mod for Fq, NW = 12, and Fr, NW = 8) on the
CPU.  csrc/ptx.cuh's PTX primitives are replaced by a host model of the
carry flag; the rest of field.cuh compiles as it is with g++, and its
results are held against Python integers on seeded inputs (random, 0, 1,
p - 1 and their neighbours; for Fr also R mod r and R^2 mod r).  The model
also fails on a carry flag read before it is set, on a carry of 1 that a
new chain would drop and on a madc.hi that overflows.  The multiply's
precondition is checked beyond canonical inputs: for any a < 2^(32 NW) - p
and any b it gives the value of a word loop that keeps every carry.  The
same sources run on the card in chip_smoke.py, where K1, K2 and every EC
kernel are held against their plain versions."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from dusk_plonk_torch.fields.constants import Q_MOD, R_MOD

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

# reads "a b" pairs of NW hex words (little-endian word order, NW = 8 or
# 12 from argv) from stdin, prints "mul add sub" for each
MAIN = r"""
#define __device__
#define __host__
#define __constant__
#define __forceinline__ inline
#include <cstdio>
#include <cstring>
#include "field.cuh"
template <int NW>
int run() {
  uint32_t a[NW], b[NW], r[NW];
  while (true) {
    for (int i = 0; i < NW; i++) if (scanf("%x", &a[i]) != 1) return 0;
    for (int i = 0; i < NW; i++) if (scanf("%x", &b[i]) != 1) return 1;
    for (int op = 0; op < 3; op++) {
      if (op == 0) mont_mul<NW>(r, a, b);
      if (op == 1) add_mod<NW>(r, a, b);
      if (op == 2) sub_mod<NW>(r, a, b);
      for (int i = 0; i < NW; i++) printf("%x ", r[i]);
    }
    printf("\n");
  }
}
int main(int argc, char** argv) {
  return argc > 1 && strcmp(argv[1], "8") == 0 ? run<8>() : run<12>();
}
"""

FIELDS = {12: Q_MOD, 8: R_MOD}
OPS = ["mont_mul", "add_mod", "sub_mod"]


def _words(x, nw):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]


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


def _fr_inputs(seed, n):
    rng = np.random.default_rng(seed)
    R = 1 << 256
    edge = [0, 1, 2, R_MOD - 1, R_MOD - 2, R % R_MOD, R * R % R_MOD,
            (1 << 254) - 1, 1 << 254, R_MOD >> 1, (R_MOD >> 1) + 1]
    pairs = [(a, b) for a in edge for b in edge]
    pairs += [(int.from_bytes(rng.bytes(32), "little") % R_MOD,
               int.from_bytes(rng.bytes(32), "little") % R_MOD)
              for _ in range(n)]
    return pairs


def _run(model, nw, pairs):
    """Each op's results as Python integers, one list per op."""
    text = "\n".join(" ".join(f"{w:x}" for w in _words(a, nw) + _words(b, nw))
                     for a, b in pairs)
    out = subprocess.run([str(model), str(nw)], input=text,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")[:-1]
    assert len(lines) == len(pairs)
    cols = [[] for _ in OPS]
    for ln in lines:
        words = ln.split()
        for k in range(len(OPS)):
            cols[k].append(_value(words[nw * k:nw * (k + 1)]))
    return cols


def _want(op, p, nw):
    rinv = pow(1 << (32 * nw), -1, p)
    return {"mont_mul": lambda a, b: a * b * rinv % p,
            "add_mod": lambda a, b: (a + b) % p,
            "sub_mod": lambda a, b: (a - b) % p}[op]


def _check(model, nw, op, pairs):
    got = _run(model, nw, pairs)[OPS.index(op)]
    want = _want(op, FIELDS[nw], nw)
    for (a, b), v in zip(pairs, got):
        assert v == want(a, b), (hex(a), hex(b))


@pytest.mark.parametrize("op", OPS)
def test_fq_carry_chains_match_python_integers(model, op):
    _check(model, 12, op, _inputs(4, 3000))


@pytest.mark.parametrize("op", OPS)
def test_fr_carry_chains_match_python_integers(model, op):
    _check(model, 8, op, _fr_inputs(5, 3000))


@pytest.mark.parametrize("nw", [8, 12])
def test_mont_mul_beyond_canonical_matches_the_word_loop(model, nw):
    """a < 2^(32 NW) - p, any b: (ab + Mp) / R with M = -ab p^-1 mod R,
    then one conditional subtraction, as a loop that keeps every carry
    computes it."""
    p, R = FIELDS[nw], 1 << (32 * nw)
    rng = np.random.default_rng(6 + nw)
    top = R - p - 1
    pairs = [(a, b) for a in (top, top - 1, p, p + 1) for b in (0, 1, R - 1)]
    pairs += [(int.from_bytes(rng.bytes(4 * nw), "little") % (R - p),
               int.from_bytes(rng.bytes(4 * nw), "little"))
              for _ in range(2000)]
    got = _run(model, nw, pairs)[0]
    npr = -pow(p, -1, R) % R
    for (a, b), v in zip(pairs, got):
        t = (a * b + (a * b * npr % R) * p) // R
        assert v == (t - p if t >= p else t), (hex(a), hex(b))
