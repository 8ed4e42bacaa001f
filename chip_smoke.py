#!/usr/bin/env python3
"""Smoke test of the torch port (dusk_plonk_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases env,kernels,small,full,msm,alt,large,
                                    sharded]

Phases, one summary line each (more for kernels):
  1. env: the card, torch / CUDA / nvcc versions, and the build of the
     CUDA kernels from dusk_plonk_torch/csrc (nvcc, sm_90a, one process per
     source);
  2. kernels: every kernel against its plain PyTorch version, limb for
     limb, at the shapes the 2^16 proof, key compilation and MSM give it,
     with both times (K7 and K8 with their chains of dependent
     multiplies), the gathers around the MSM's K9 launch, and K11a and K4
     at the widest row group of a 2^20 commit batch;
  3. small: at k = 7, device SRS setup equal to the host setup, device key
     compilation equal to the host compilation (verification key bytes),
     and a proof equal to the host oracle's field for field, verified;
  4. full: bench.py's proof path at 2^16 constraints: PlonkParams.
     setup_device, PlonkKey.compile_device (per-step times, 16 SRS powers
     spot-checked against the host), one warm and two timed proofs, the
     host verifier, and each kernel's launches on each path (> 0); then
     a fourth proof's round-3 inputs, on which K14 (the quotient grid) is
     held against its plain version limb for limb at the full (16, 2^19)
     width (the plain chain's multiplies on K1), on the grid's last
     2^16 columns with the wraparound halo and on its first 32 and 1,000
     columns (K1's plain multiply), timed through its wrapper and at its
     C entry, with its registers and spills;
  5. msm: bench.py's MSM metric, MsmPlan.msm_device on 2^16 seeded
     points, equal to the host C++ MSM, best of 3 in points/s;
  6. alt: the JAX package's switched-off configuration (ntt_mxu_min_k =
     16: every NTT on the four-step int8 tensor-core route, kernel K13;
     ec_scan_em: every chunk scan on kernel K12) through setup, compile and
     proofs at 2^16, each equal to the default configuration's byte for
     byte, the msm phase under ec_scan_em, and the JAX MSM's per-step scan
     route (one kernel K10 launch a step) at 2^10 points;
  7. large: bench.py's 2^20 path on one card: setup_device(20),
     compile_device (the MSM in row groups under config.msm_group_slots),
     a warm and a timed proof verified on the host, per-step times and
     peak GiB, each kernel's launches by shape with device ms beside its
     bound, a third proof's round-3 inputs, on which K14 is held against
     its plain version as in phase full at (16, 2^23), and one 2^20
     commitment equal under the default cap, under one row a group and
     on the host C++ MSM;
  8. sharded: the multi-device engine (proving/sharded_engine.py) on a
     one-process mesh whose D shards all live on cuda:0: phase small's
     mixed circuit at D = 2 and 8 and the n = 64 wide circuit at D = 8,
     each proof equal to the host oracle's and verified; the 2^16 bench
     circuit at D = 4 and 8 from phase full's device key, a warm and two
     timed proofs each equal to the single-device engine's proof from the
     same seed and verified, with per-round times, launches by kernel and
     shape and the tracer's collective bytes beside the scaling model's;
     ShardedMsm at 2^16 over 4 shards under both tiers, equal to the host
     C++ MSM.  Every kernel at every shape that the small proofs, the
     warm 2^16 proofs and the warm ShardedMsm calls launch (ShapeCapture
     keeps each shape's first arguments) is held against its plain
     version limb for limb.
     One card: the collectives are device-local copies, so no time here
     measures scaling.

Then a JSON line of per-kernel results (with each kernel's bound), the
card's name and power limit, and, last, {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; without CUDA it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "small", "full", "msm", "alt", "large",
          "sharded")
K = 16          # log2 constraints of the full-width proof (bench.py's 2^16)
K_LARGE = 20    # and of the large proof (bench.py's 2^20)
SHARDS = (4, 8)  # the sharded 2^16 proof's mesh sizes, all on cuda:0


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs after one warm-up, by
    CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_runs(fn, reps, runs=5):
    """(median, all): device ms per call of fn(), `runs` measurements of
    `reps` back-to-back calls each by CUDA events, after one warm-up."""
    ms = [cuda_ms(fn, reps) for _ in range(runs)]
    return statistics.median(ms), ms


def cuda_once(fn):
    """(fn(), device ms of that one call by CUDA events), no warm-up: for
    the plain versions, whose single call takes up to seconds."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# -- the card's bound for a kernel's work ------------------------------------------

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT_MULS_PER_SM_CLOCK = 64    # 32-bit integer multiply(-add)s per SM per
                              # clock, compute capability 9.0 (CUDA C++
                              # Programming Guide, arithmetic throughput)
# 32x32 -> 64 multiplies in one CIOS Montgomery multiply of NW words:
# NW^2 for a b, NW^2 for m p, NW for m = t_0 n'
FR_MUL, FQ_MUL = 2 * 8 * 8 + 8, 2 * 12 * 12 + 12
EC_ADD, EC_ADD_MIXED = 12 * FQ_MUL, 11 * FQ_MUL     # RCB15 complete / mixed
EC_DBL = 8 * FQ_MUL                                 # RCB15 doubling (a = 0)
# Fq multiplies of one complete add and one doubling on one thread: the
# length of their dependent chains (a team of threads runs either in two)
ADD_MULS, DBL_MULS = 12, 8
# K13's wide Montgomery reduction by 2^272: eight 32-bit steps (m, then
# m p over 8 words) and one 16-bit step
REDUCE_PLANES = 8 * (1 + 8) + (1 + 8)
# K14's Fr multiplies an element (csrc/quotient.cuh's count: the small
# constants' multiplies are adds), each quotient.cuh::fr_mont_mul's 8 rows
# of 8 a b and 6 m r products (m, m r0 and m r1 are adds), and the limb
# rows it reads an element (evs 6, sel 11, sig 4, l1, lin, vh_inv)
QUOTIENT_MULS, FR_MUL_SHAPED, QUOTIENT_ROWS = 86, 8 * (8 + 6), 24
# the one-thread design's count, 93 of FR_MUL, printed beside the bound
QUOTIENT_MULS_ONE_THREAD = 93
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak


def int_mul_rate():
    """The card's peak 32-bit integer multiply rate: SMs x 64 a clock x
    the maximum SM clock nvidia-smi reports."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_MULS_PER_SM_CLOCK * mhz * 1e6


def bound(nbytes, muls, rate):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    integer multiplies over the card's integer rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = muls / rate
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def rand_limbs(gen, F, shape, device):
    """Random canonical field elements as limbs: the top limb is masked
    with half the modulus's top limb, so every value is < p."""
    import torch
    L = F.L
    x = torch.randint(0, 1 << 16, tuple(shape[:-1]) + (L, shape[-1]),
                      generator=gen, dtype=torch.int32)
    x[..., L - 1, :] &= (F.spec.modulus >> (16 * L - 16)) >> 1
    return x.to(device)


def max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.long() - b.long()).abs().max())


# -- circuits ----------------------------------------------------------------------

def mixed_circuit():
    from dusk_plonk_torch.prelude import (
        BLS_SCALAR_MODULUS as R_MOD, Circuit, Constraint)

    class MixedCircuit(Circuit):
        """Arithmetic + range + logic + public input."""

        def __init__(self, a=13, b=5):
            self.a = a
            self.b = b

        def synthesize(self, composer):
            w_a = composer.append_witness(self.a)
            w_b = composer.append_witness(self.b)
            prod = composer.gate_mul(Constraint().mult(1).a(w_a).b(w_b))
            composer.assert_equal_constant(prod, 0,
                                           (-self.a * self.b) % R_MOD)
            composer.component_range(w_a, 6)
            composer.append_logic_and(w_a, w_b, 8)
            composer.append_logic_xor(w_a, w_b, 8)

    return MixedCircuit


def bench_circuit(k):
    """The 2^k circuit of bench.py::_bench_circuit: a mul chain, a 64-bit
    range check and 128-bit XOR / AND."""
    from dusk_plonk_torch.prelude import Circuit
    n_mul_gates = max(1, (1 << k) - 700)

    class BenchCircuit(Circuit):
        def __init__(self, x=3):
            self.x = x

        def synthesize(self, c):
            w = c.append_witness(self.x)
            acc = c.append_witness(1)
            acc = c.append_mul_chain(acc, w, n_mul_gates)
            c.component_range(w, 64)
            c.append_logic_xor(w, acc, 128)
            c.append_logic_and(w, acc, 128)

    return BenchCircuit


PROOF_FIELDS = ("a_comm", "b_comm", "c_comm", "d_comm", "z_comm",
                "t_low_comm", "t_mid_comm", "t_high_comm", "t_4_comm",
                "w_z_chall_comm", "w_z_chall_w_comm", "evaluations")


# -- phases ------------------------------------------------------------------------

def ptxas_table(log_path):
    """{kernel: {registers, spill_stores, spill_loads}} from the build
    log's `nvcc -Xptxas -v` lines (kernel = mangled entry name)."""
    table, cur = {}, None
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                cur = table.setdefault(m.group(1), {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m[1])
    return table


# the kernels whose registers and spills the env line names
PTXAS_FOCUS = {"K1 Fr <8>": "mont_mul_kernelILi8", "K1 Fq <12>":
               "mont_mul_kernelILi12", "K2": "ntt_pass_kernel",
               "K7": "ec_double_add_kernel", "K11b": "ec_sum_steps_kernel",
               "K8": "ec_combine_kernel", "K9": "ec_add_kernel",
               "K10": "ec_add_mixed_kernelILi6E",
               "K11a": "ec_scan_mixed_kernel", "K12": "ec_scan_em_kernel",
               "K12 team 3": "ec_scan_em_team_kernelILi3E",
               "K12 team 6": "ec_scan_em_team_kernelILi6E",
               "K14": "quotient_groups_kernel"}


def phase_env():
    import torch
    from dusk_plonk_torch import native
    from dusk_plonk_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    native.lib()                        # the host C++ engine, or raise
    ptxas = ptxas_table(_build.BUILD_LOG)
    focus = {short: [v for k, v in ptxas.items() if key in k]
             for short, key in PTXAS_FOCUS.items()}
    if not all(len(v) == 1 for v in focus.values()):
        raise AssertionError(f"ptxas: focus kernels not found once: {focus}")
    say("env", gpu=nvidia_smi_line(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        nvcc=nvcc.strip().splitlines()[-1], build_s=build_s,
        int_muls_per_s=int_mul_rate(), hbm_bytes_per_s=HBM_BYTES_PER_S,
        ptxas_focus={k: v[0] for k, v in focus.items()}, ptxas=ptxas)


def mont_mul_entry(F, a, b):
    """(launch, out): a closure that launches K1 on a, b through its C
    entry point alone, as ops/kernels.py::mont_mul passes them, into one
    preallocated output -- the kernel's device time without the wrapper's
    host work (and without its launch count)."""
    import math
    import torch
    from dusk_plonk_torch.ops import _build, kernels
    shape = torch.broadcast_shapes(a.shape, b.shape)
    ea, sa = kernels._row_strides(a, shape)
    eb, sb = kernels._row_strides(b, shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    entry = _build.lib().dt_mont_mul
    args = (F.L, kernels._ptr(ea), *sa, kernels._ptr(eb), *sb,
            kernels._ptr(out), math.prod(shape[:-2]), shape[-1],
            kernels._stream(out.device))

    def launch():
        _build.check(entry(*args), "mont_mul")
    return launch, out


def add_mixed_entry(p, q2):
    """(launch, out): as mont_mul_entry, K10's C entry point alone on
    p + q2."""
    import math
    import torch
    from dusk_plonk_torch.ops import _build, kernels
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    entry = _build.lib().dt_ec_add_mixed
    args = (*(kernels._ptr(c) for c in p + q2 + out),
            math.prod(p[0].shape[:-2]), p[0].shape[-1],
            kernels._stream(out[0].device))

    def launch():
        _build.check(entry(*args), "ec_add_mixed")
    return launch, out


def quotient_entry(args):
    """(launch, out): as mont_mul_entry, K14's C entry point alone on the
    wrapper's arguments (F, evs, halo, sel8, sig8, l1_8, lin8, vh_inv8,
    consts)."""
    import torch
    from dusk_plonk_torch.ops import _build, kernels
    evs, consts = args[1], args[-1]
    out = torch.empty((16, evs.shape[-1]), dtype=torch.int32,
                      device=evs.device)
    entry = _build.lib().dt_quotient
    call = (*(kernels._ptr(t) for t in args[1:]), kernels._ptr(out),
            evs.shape[-1], consts.shape[-1], kernels._stream(out.device))

    def launch():
        _build.check(entry(*call), "quotient")
    return launch, out


def quotient_work(E, columns, muls=QUOTIENT_MULS * FR_MUL_SHAPED):
    """(bytes, 32-bit multiplies) of K14 on E points, `muls` a point:
    each input row and the output once, the halo and the table once."""
    return ((QUOTIENT_ROWS + 1) * 64 * E + 4 * 16 * 8 * 4
            + 16 * columns * 4, E * muls)


def phase_kernels(shapes):
    """Each kernel vs its plain version on the same inputs; the first case
    of each kernel is its headline shape, whose bound the JSON line
    carries."""
    import torch
    from dusk_plonk_torch.ops import kernels, mxu_ntt
    from dusk_plonk_torch.ops.limb import fr_field, fq_field
    from dusk_plonk_torch.ops.ntt import NttPlan, ladder_oracle
    from dusk_plonk_torch.ops.ec import device_g1
    from dusk_plonk_torch.ops.msm import MsmPlan
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkParams
    from dusk_plonk_torch.utils import config
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8349)
    Fr, Fq, G1 = fr_field(), fq_field(), device_g1()
    rate = int_mul_rate()
    results = {}

    def record(name, key, out, ref, ms, plain_ms, work, **extra):
        err = max_abs_err(out, ref)
        bound_ms, bound_by = bound(*work, rate)
        say("kernels", kernel=name, case=key, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, **extra)
        if err != 0:
            raise AssertionError(f"{name} {key}: kernel != plain ({err})")
        r = results.setdefault(name, {"max_abs_err": 0, "case": key,
                                      "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound_ms,
                                      "bound_by": bound_by})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def check(name, key, fn, plain, reps, work):
        out = fn()
        ref, plain_ms = cuda_once(plain)
        record(name, key, out, ref, cuda_ms(fn, reps), plain_ms, work)

    # K1 at the proof's shapes: Fr at the 8n quotient width (one row, and
    # the round-3 coset batch of 6 rows times one broadcast row), at the
    # SRS width (ragged: n is odd), at n and at one element (LimbField.inv's
    # square-and-multiply, most of K1's launches); an operand given as an
    # offset view (unaligned: element by element); a (16, 1) scalar (the NTT
    # scales, from_mont's one); Fq at the SRS packing width and at the JAX
    # MSM's padded lane width.  Each time is the median of 5 measurements of
    # 100 launches: `ms` of the C entry point alone (the kernel's device
    # time), `wrapper_ms` through LimbField.mul, whose host work per call
    # can exceed the kernel's time.
    n19, n16, nsrs = 1 << 19, 1 << 16, shapes["srs"]
    wide = rand_limbs(gen, Fr, (n16 + 1,), dev)
    k1_cases = (
        ("Fr(1,2^19)", Fr, (n19,), (n19,)),
        ("Fr(6,2^19)x(16,2^19)", Fr, (6, n19), (n19,)),
        (f"Fr(1,{nsrs})", Fr, (nsrs,), (nsrs,)),
        ("Fr(1,2^16)", Fr, (n16,), (n16,)),
        ("Fr(1,1)", Fr, (1,), (1,)),
        ("Fr(1,2^16) offset view", Fr, None, (n16,)),
        ("Fr(1,2^19)x(16,1)", Fr, (n19,), (1,)),
        (f"Fq(1,{nsrs})", Fq, (nsrs,), (nsrs,)),
        ("Fq(1,5760)", Fq, (5760,), (5760,)))
    for key, F, sa, sb in k1_cases:
        a = wide[:, 1:] if sa is None else rand_limbs(gen, F, sa, dev)
        b = rand_limbs(gen, F, sb, dev)
        out = F.mul(a, b)
        ref, plain_ms = cuda_once(lambda: F.mul_plain(a, b))
        launch, raw = mont_mul_entry(F, a, b)
        med, runs = cuda_ms_runs(launch, 100)
        wrapper_ms, wrapper_runs = cuda_ms_runs(lambda: F.mul(a, b), 100)
        record("mont_mul", key, (out, raw), (ref, ref), med, plain_ms,
               ((a.numel() + b.numel() + out.numel()) * 4,
                out.numel() // F.L * (FR_MUL if F.L == 16 else FQ_MUL)),
               ms_runs=runs, ms_spread=max(runs) - min(runs),
               wrapper_ms=wrapper_ms, wrapper_ms_runs=wrapper_runs)
        del a, b, out, ref, raw

    # K2: the proof's five transforms (round-3 coset pair at 8n, the
    # round-1 wire iNTTs at n, two single iNTTs at n), then dft / coset_dft
    # at the widths of the JAX engine's batches, key compilation's 11 + 4
    # selector and sigma iNTTs, one transform each of the k = 7 proof, of
    # one pass at its largest (k = 10) and of the smallest two-pass split
    # (k = 11), and one 2^23 transform (a k = 20 proof's 8n domain).  Each
    # whole transform (scales included) against the kernel's plain version
    # and against the radix-2 ladder of earlier versions (scale, bit
    # reversal, k stages, scale), limb for limb.  Bound: one
    # read and one write of the data and each table once, or the butterfly
    # and scale multiplies; `passes_bound_ms` counts the bytes of the
    # passes made (each pass reads and writes the data, and its tables).
    plans = {}
    for k, batch, kind in ((19, 6, "coset_dft"), (19, 1, "coset_idft"),
                           (16, 4, "idft"), (16, 1, "idft"), (16, 4, "dft"),
                           (16, 4, "coset_dft"), (19, 2, "dft"),
                           (19, 2, "coset_dft"), (16, 11, "idft"),
                           (7, 4, "idft"), (10, 1, "coset_dft"),
                           (11, 2, "coset_idft"), (23, 1, "coset_dft")):
        if k not in plans:
            plans[k] = NttPlan(k, dev)
        plan = plans[k]
        n = 1 << k
        x = rand_limbs(gen, Fr, (batch, n), dev)
        out = getattr(plan, kind)(x)
        inverse = kind in ("idft", "coset_idft")
        steps = plan.steps_inv if inverse else plan.steps_fwd
        pre = plan.scale_coset if kind == "coset_dft" else None
        post = {"idft": plan.scale_n_inv,
                "coset_idft": plan.scale_coset_inv}.get(kind)
        ref, plain_ms = cuda_once(
            lambda: kernels.ntt_plain(Fr, x, k, steps, pre, post))
        oracle = ladder_oracle(Fr, k, kind, x)
        err_oracle = max_abs_err(out, oracle)
        tables = sum(t.numel() * 4 for _, r, d in steps
                     for t in (r, d) if t is not None)
        scales = sum(t.numel() * 4 for t in (pre, post) if t is not None)
        scale_muls = sum(n for t in (pre, post) if t is not None)
        data = batch * 16 * n * 4
        passes_bytes = len(steps) * 2 * data + tables + scales
        record("ntt", f"{kind}(B={batch},k={k})", out, ref,
               cuda_ms(lambda: getattr(plan, kind)(x), 5), plain_ms,
               (2 * data + tables + scales,
                batch * (k * (n // 2) + scale_muls) * FR_MUL),
               passes=[(p.log_m, p.lines) for p in plan.passes],
               passes_bound_ms=passes_bytes / HBM_BYTES_PER_S * 1e3,
               max_abs_err_vs_ladder=err_oracle)
        if err_oracle != 0:
            raise AssertionError(f"ntt {kind} k={k}: != the ladder "
                                 f"({err_oracle})")
        r = results["ntt"]
        r["max_abs_err_vs_ladder"] = max(err_oracle,
                                         r.get("max_abs_err_vs_ladder", 0))
        del x, out, ref, oracle
    del plans[23]

    # K13: the four-step route's plane reduction at the alt path's
    # transform shapes (round 1's iNTTs at n, round 3's coset batch at 8n),
    # on real digit products of the plan's DFT matrix; beside it, for each
    # matrix step, the 33 torch._int_mm calls of one mod_matmul alone and
    # with the plane accumulation, and one whole four-step transform
    # against the K2 ladder on the same input
    old = config.get_config()
    config.set_config(ntt_mxu_min_k=16)
    try:
        mxu_plans = {k: NttPlan(k, dev) for k in (16, 19)}
    finally:
        config.set_config(ntt_mxu_min_k=old.ntt_mxu_min_k)
    for k, batch, kind in ((16, 4, "idft"), (19, 6, "coset_dft")):
        plan = mxu_plans[k]
        n = 1 << k
        n1, n2 = mxu_ntt.split(k)
        x = rand_limbs(gen, Fr, (batch, n), dev)
        xd = mxu_ntt._to_digits(x)                         # (B, 33, n)
        planes = mxu_ntt.int8_products(
            plan.tw_fwd.w2d, xd.reshape(batch, 33, n2, n1)).reshape(
                batch, 65, n)
        check("reduce_planes", f"(B={batch},65,2^{k})",
              lambda: kernels.reduce_planes(Fr, planes),
              lambda: kernels.reduce_planes_plain(Fr, planes), 20,
              (batch * n * (65 + 16) * 4, batch * n * REDUCE_PLANES))
        steps = {}
        for step, wd, mi, t in ((1, plan.tw_fwd.w2d, n2, n1),
                                (2, plan.tw_fwd.w1d, n1, n2)):
            xs = xd.reshape(batch, 33, mi, t)
            a = wd.reshape(33 * mi, mi)
            cols = xs.permute(1, 2, 0, 3).reshape(33, mi, batch * t)

            # the same products with the right operand K-major (a
            # transposed view of (B t, mi) rows), a layout probe for
            # cuBLASLt's int8 path; the port passes it N-major
            kcols = xs.permute(1, 0, 3, 2).reshape(33, batch * t, mi)
            if not torch.equal(mxu_ntt._int8_mm(a, cols[0]),
                               mxu_ntt._int8_mm(a, kcols[0].t())):
                raise AssertionError("int8 products depend on the layout")

            def products(right):
                for l in range(33):
                    mxu_ntt._int8_mm(a, right(l))
            steps[step] = {
                "int_mm_ms": cuda_ms(lambda: products(lambda l: cols[l]), 3),
                "int_mm_kmajor_ms": cuda_ms(
                    lambda: products(lambda l: kcols[l].t()), 3),
                "int8_products_ms": cuda_ms(
                    lambda: mxu_ntt.int8_products(wd, xs), 3),
                "int8_bound_ms": 2 * 33 * 33 * mi * mi * batch * t
                / INT8_OPS_PER_S * 1e3}
        out = getattr(plan, kind)(x)
        err = max_abs_err(out, getattr(plans[k], kind)(x))
        say("kernels", four_step=f"{kind}(B={batch},k={k})", n1=n1, n2=n2,
            steps=steps,
            four_step_ms=cuda_ms(lambda: getattr(plan, kind)(x), 3),
            ladder_ms=cuda_ms(lambda: getattr(plans[k], kind)(x), 3),
            max_abs_err_vs_ladder=err)
        if err != 0:
            raise AssertionError(f"four-step {kind} k={k} != the ladder")

    # points: 64 SRS powers of a seeded setup, random projective
    # representatives of them
    host = PlonkParams.setup(6, ChaCha12Rng.seed_from_u64(8349)).powers[:64]
    aff = G1.pack_points(host, dev)                    # (24, 64) z = 1

    def proj(lanes):
        idx = torch.randint(0, 64, (lanes,), generator=gen).to(dev)
        zr = rand_limbs(gen, Fq, (lanes,), dev)
        x, y = aff[0][:, idx], aff[1][:, idx]
        return (Fq.mul(x, zr), Fq.mul(y, zr), zr.clone())

    def proj_steps(steps, lanes):
        """((steps, 24, lanes),)*3 with an identity at (0, 0), and where
        there are 3 lanes, P + P on lane 1 and P + (-P) on lane 2 (steps 0
        and 1)."""
        g = tuple(c.reshape(24, steps, lanes).permute(1, 0, 2).contiguous()
                  for c in proj(steps * lanes))
        for c, i in zip(g, G1.identity(dev)):
            c[0, :, 0:1] = i
        if steps > 1 and lanes > 2:
            for c, cn in zip(g, G1.neg(tuple(c[0] for c in g))):
                c[1, :, 1] = c[0, :, 1]
                c[1, :, 2] = cn[:, 2]
        return g

    # K9 at the bucket-tail read widths of one and of four 2^16 commits;
    # identity, P + P and P + (-P) lanes
    ident = G1.identity(dev)
    for lanes in (shapes["tails"], 4 * shapes["tails"]):
        p, q = proj(lanes), proj(lanes)
        q = tuple(c.clone() for c in q)
        for c, i in zip(q, ident):
            c[:, 0:1] = i                                   # P + O
        for c, i in zip(p, ident):
            c[:, 1:2] = i                                   # O + Q
        for cp, cq, i in zip(p, q, ident):
            cp[:, 2:3] = i
            cq[:, 2:3] = i                                  # O + O
        for cp, cq in zip(p, q):
            cq[:, 3:8] = cp[:, 3:8]                         # P + P
        negp = G1.neg(p)
        for cq, cn in zip(q, negp):
            cq[:, 8:13] = cn[:, 8:13]                       # P + (-P)
        out = G1.add(p, q)
        # group law on the special lanes: P + O = P, O + Q = Q, O + O = O,
        # P + (-P) = O
        got = G1.to_affine(tuple(c[:, :13] for c in out))
        hp = G1.to_affine(tuple(c[:, :13] for c in p))
        hq = G1.to_affine(tuple(c[:, :13] for c in q))
        if (got[0] != hp[0] or got[1] != hq[1] or got[2] is not None
                or any(got[i] is not None for i in range(8, 13))):
            raise AssertionError("ec_add: group law violated on special "
                                 "lanes")
        check("ec_add", f"lanes={lanes}", lambda: kernels.ec_add(G1, p, q),
              lambda: kernels.ec_add_plain(G1, p, q), 20,
              (9 * 24 * lanes * 4, lanes * EC_ADD))
        del p, q, out, negp

    # the gathers around the MSM's K9 launch (MsmPlan._tail_reads: scan
    # values and chunk offsets at the bucket tails) and the identity select
    # after it, at the shapes of one and four 2^16 commits, beside K9 on
    # their output
    plan = MsmPlan(shapes["srs"])
    cl, nc, M = plan.chunk_len, shapes["chunks"], plan.nb + 1
    for B in (1, 4):
        R = B * shapes["windows"]
        idx = torch.sort(torch.randint(-1, plan.n_pad, (R, M),
                                       generator=gen), dim=-1).values.to(dev)
        ps = tuple(rand_limbs(gen, Fq, (cl, R * nc), dev) for _ in range(3))
        offsets = tuple(rand_limbs(gen, Fq, (R * nc,), dev)
                        for _ in range(3))
        neg, vals, offs = plan._tail_reads(idx, ps, offsets, nc)
        summed = G1.add(vals, offs)
        ident_rm = G1.broadcast_identity((), R * M, dev)
        say("kernels", tail_reads=f"(B={B},lanes={R * M})",
            gathers_ms=cuda_ms(lambda: plan._tail_reads(idx, ps, offsets,
                                                        nc), 10),
            select_ms=cuda_ms(lambda: G1.select(neg, ident_rm, summed), 10),
            ec_add_ms=cuda_ms(lambda: G1.add(vals, offs), 10))
        del ps, offsets, vals, offs, summed

    # K10: DeviceG1.add_mixed at the JAX MSM's per-step scan width (W nc
    # lanes of a 2^10-point MSM), and at 81,940 lanes, a launch that fills
    # the card (no path launches K10 that wide); lane 0 adds to the
    # identity, lane 1 doubles (p = q), lane 2 gives the identity (p = -q).
    # `ms` is the C entry point alone, median of 5 x 100 launches from
    # Python (the ctypes calls may hold the queue at 148 lanes:
    # tools/kernel_variants/k12_variants.py times a C-side loop),
    # `wrapper_ms` through DeviceG1.add_mixed; the chain counts dependent Fq
    # multiplies on the team of six (levels of 5 and 6 products)
    one = Fq.const("one_mont", dev)
    for lanes in (shapes["step_lanes"], shapes["tails"]):
        p = tuple(c.clone() for c in proj(lanes))
        idx = torch.randint(0, 64, (lanes,), generator=gen).to(dev)
        q2 = (aff[0][:, idx].contiguous(), aff[1][:, idx].contiguous())
        for c, i in zip(p, ident):
            c[:, 0:1] = i
        p[0][:, 1:3] = q2[0][:, 1:3]
        p[1][:, 1:2] = q2[1][:, 1:2]
        p[1][:, 2:3] = Fq.neg(q2[1][:, 2:3])
        p[2][:, 1:3] = one
        q3 = (q2[0][:, :2], q2[1][:, :2], one.expand(24, 2).contiguous())
        got = G1.to_affine(tuple(c[:, :3] for c in G1.add_mixed(p, q2)))
        want = G1.to_affine(G1.add(q3, q3))
        if (got[0] != G1.to_affine(q3)[0] or got[1] != want[1]
                or got[2] is not None):
            raise AssertionError("ec_add_mixed: group law violated on "
                                 "special lanes")
        out = G1.add_mixed(p, q2)
        ref, plain_ms = cuda_once(
            lambda: kernels.ec_add_mixed_plain(G1, p, q2))
        launch, raw = add_mixed_entry(p, q2)
        med, runs = cuda_ms_runs(launch, 100)
        wrapper_ms, wrapper_runs = cuda_ms_runs(
            lambda: kernels.ec_add_mixed(G1, p, q2), 100)
        record("ec_add_mixed", f"lanes={lanes}", (out, raw), (ref, ref), med,
               plain_ms, (8 * 24 * lanes * 4, lanes * EC_ADD_MIXED), team=6,
               ms_runs=runs, wrapper_ms=wrapper_ms,
               wrapper_ms_runs=wrapper_runs, chain_muls=2,
               us_per_chain_mul=med * 1e3 / 2)
        del p, q2, out, ref, raw

    # K11a: the chunk scan of one 2^16 commit, of the proof's 4-commit
    # batch, and at the JAX MSM's padded lane width
    cl = 256
    for lanes in (shapes["scan"], 4 * shapes["scan"], 5760):
        idx = torch.randint(0, 64, (cl * lanes,), generator=gen).to(dev)
        g = torch.cat([aff[0][:, idx], aff[1][:, idx]]).reshape(
            48, cl, lanes).permute(1, 0, 2).contiguous()
        check("ec_scan_mixed", f"(cl={cl},48,lanes={lanes})",
              lambda: kernels.ec_scan_mixed(G1, g),
              lambda: kernels.ec_scan_mixed_plain(G1, g), 3,
              (cl * lanes * (48 + 72) * 4, cl * lanes * EC_ADD_MIXED))
    # and at the widest group of a k = 20 commit batch, the cap's rows of
    # 4,097 chunks (1.56e9 input words: 64-bit offsets); limb for limb
    # against the plain version on the first and last 512 lanes (lanes are
    # independent, and the whole plain scan would take minutes)
    lanes = shapes["k20"]["group_rows"] * shapes["k20"]["chunks"]
    idx = torch.randint(0, 64, (cl * lanes,), generator=gen).to(dev)
    g = torch.cat([aff[0][:, idx], aff[1][:, idx]]).reshape(
        48, cl, lanes).permute(1, 0, 2).contiguous()
    del idx
    out = kernels.ec_scan_mixed(G1, g)
    ms = cuda_ms(lambda: kernels.ec_scan_mixed(G1, g), 1)
    sl = torch.cat([torch.arange(512),
                    torch.arange(lanes - 512, lanes)]).to(dev)
    gs = g[:, :, sl].contiguous()
    del g
    ref, plain_ms = cuda_once(lambda: kernels.ec_scan_mixed_plain(G1, gs))
    record("ec_scan_mixed", f"(cl={cl},48,lanes={lanes})",
           tuple(c[:, :, sl] for c in out), ref, ms, plain_ms,
           (cl * lanes * (48 + 72) * 4, cl * lanes * EC_ADD_MIXED),
           plain_lanes=len(sl))
    del out, ref, gs

    # K12: the element-major chunk scan at the alt path's launches: an alt
    # proof's B = 1, 2, 4 batches (5,140 lanes, also msm_device's; 10,280;
    # 20,560) and key compilation's B = 15 (77,100), each on _scan_team's
    # team (N threads a mixed add; 1: one thread a lane).  Limb for limb
    # against the plain version (at 77,100 lanes on the first and last 512
    # lanes alone: lanes are independent, and the whole plain scan would
    # take minutes) and against K11a on the same input (both keep the
    # sequential order)
    for lanes in (shapes["scan"], 2 * shapes["scan"], 4 * shapes["scan"],
                  15 * shapes["scan"]):
        idx = torch.randint(0, 64, (cl * lanes,), generator=gen).to(dev)
        g = torch.cat([aff[0][:, idx], aff[1][:, idx]]).reshape(
            48, cl, lanes).permute(1, 0, 2).contiguous()
        del idx
        team = kernels._scan_team(lanes)
        out = kernels.ec_scan_mixed_em(G1, g)
        ms = cuda_ms(lambda: kernels.ec_scan_mixed_em(G1, g), 3)
        sl = None if lanes <= 4 * shapes["scan"] else torch.cat(
            [torch.arange(512), torch.arange(lanes - 512, lanes)]).to(dev)
        gs = g if sl is None else g[:, :, sl].contiguous()
        ref, plain_ms = cuda_once(
            lambda: kernels.ec_scan_mixed_em_plain(G1, gs))
        mine = out if sl is None else out[:, sl]
        record("ec_scan_mixed_em", f"(cl={cl},48,lanes={lanes})", mine, ref,
               ms, plain_ms, (cl * lanes * (48 + 72) * 4,
                              cl * lanes * EC_ADD_MIXED),
               team=team, chain_muls_a_step=(11 if team == 1 else
                                             -(-5 // team) + -(-6 // team)),
               plain_lanes=lanes if sl is None else len(sl))
        del ref, gs
        seq = kernels.ec_scan_mixed(G1, g)
        if sl is not None:
            seq = tuple(c[:, :, sl] for c in seq)
        err = max_abs_err(tuple(mine[:, :, 24 * i:24 * (i + 1)]
                                .transpose(1, 2) for i in range(3)), seq)
        say("kernels", kernel="ec_scan_mixed_em",
            case=f"(cl={cl},48,lanes={lanes})", team=team,
            max_abs_err_vs_k11a=err)
        if err != 0:
            raise AssertionError(f"ec_scan_mixed_em lanes={lanes}: not "
                                 f"K11a's scan ({err})")
        r = results["ec_scan_mixed_em"]
        r["max_abs_err_vs_k11a"] = max(err, r.get("max_abs_err_vs_k11a", 0))
        del g, out, mine, seq

    # K11b: level 1 (sb steps on W * sa lanes a commit) and level 2 (sa
    # steps on W lanes) of the bucket sum, at every batch a proof (B = 4,
    # 1, 2), key compilation (B = 15) and msm_device (B = 1) launches;
    # limb for limb against the plain version in the kernel's block order,
    # and in affine form against the sequential order (the JAX kernel's)
    W, sa, sb = shapes["windows"], shapes["sa"], shapes["sb"]
    for steps, lanes in ([(sb, B * W * sa) for B in (4, 1, 2, 15)]
                         + [(sa, B * W) for B in (4, 1, 2)]):
        g = proj_steps(steps, lanes)
        block = kernels._sum_block(steps, lanes)
        case = f"(steps={steps},lanes={lanes},block={block})"
        check("ec_sum_steps", case, lambda: kernels.ec_sum_steps(G1, g),
              lambda: kernels.ec_sum_steps_plain(G1, g, block), 5,
              ((steps + 1) * 72 * lanes * 4, steps * lanes * EC_ADD))
        err = max_abs_err(G1.affine(kernels.ec_sum_steps(G1, g)),
                          G1.affine(kernels.ec_sum_steps_plain(G1, g)))
        say("kernels", kernel="ec_sum_steps", case=case,
            max_abs_err_affine_vs_sequential=err)
        if err != 0:
            raise AssertionError(f"ec_sum_steps {case}: not the sequential "
                                 f"sum's points ({err})")
        r = results["ec_sum_steps"]
        r["max_abs_err_affine_vs_sequential"] = max(
            err, r.get("max_abs_err_affine_vs_sequential", 0))

    # K4: the chunk offsets, nc steps on one lane per (commit, window);
    # limb for limb against the plain version in the kernel's block order,
    # and in affine form against the sequential order (the JAX kernel's)
    nc = shapes["chunks"]
    block = kernels._excl_block(nc)
    for lanes in (4 * W, 15 * W):
        g = proj_steps(nc, lanes)
        check("ec_scan_excl", f"(steps={nc},lanes={lanes},block={block})",
              lambda: kernels.ec_scan_excl(G1, g),
              lambda: kernels.ec_scan_excl_plain(G1, g, block), 3,
              (2 * nc * 72 * lanes * 4, (nc - 1) * lanes * EC_ADD))
        err = max_abs_err(G1.affine(kernels.ec_scan_excl(G1, g)),
                          G1.affine(kernels.ec_scan_excl_plain(G1, g)))
        say("kernels", kernel="ec_scan_excl", case=f"(steps={nc},"
            f"lanes={lanes})", max_abs_err_affine_vs_sequential=err)
        if err != 0:
            raise AssertionError(f"ec_scan_excl lanes={lanes}: not the "
                                 f"sequential scan's points ({err})")
        r = results["ec_scan_excl"]
        r["max_abs_err_affine_vs_sequential"] = max(
            err, r.get("max_abs_err_affine_vs_sequential", 0))
    # and at a k = 20 commit's chunk count (the widest group of its rows,
    # shapes["k20"]): runs of 33 steps, limb for limb against the plain
    # version in the kernel's block order
    nc20, rows20 = shapes["k20"]["chunks"], shapes["k20"]["group_rows"]
    block = kernels._excl_block(nc20)
    g = proj_steps(nc20, rows20)
    check("ec_scan_excl", f"(steps={nc20},lanes={rows20},block={block})",
          lambda: kernels.ec_scan_excl(G1, g),
          lambda: kernels.ec_scan_excl_plain(G1, g, block), 3,
          (2 * nc20 * 72 * rows20 * 4, (nc20 - 1) * rows20 * EC_ADD))
    del g

    # chunk-length sweep for a later choice of msm_chunk_len: K11a on
    # W n_pad / cl lanes a commit and K4 on n_pad / cl steps, B = 1 and 4
    sweep = []
    for cl in (64, 128, 256):
        steps = -(-shapes["srs"] // cl)
        for B in (1, 4):
            lanes = W * steps * B
            idx = torch.randint(0, 64, (cl * lanes,), generator=gen).to(dev)
            g = torch.cat([aff[0][:, idx], aff[1][:, idx]]).reshape(
                48, cl, lanes).permute(1, 0, 2).contiguous()
            ge = proj_steps(steps, W * B)
            scan_ms = cuda_ms(lambda: kernels.ec_scan_mixed(G1, g), 3)
            excl_ms = cuda_ms(lambda: kernels.ec_scan_excl(G1, ge), 3)
            sweep.append({"cl": cl, "B": B, "scan_lanes": lanes,
                          "excl_steps": steps,
                          "excl_block": kernels._excl_block(steps),
                          "ec_scan_mixed_ms": scan_ms,
                          "ec_scan_excl_ms": excl_ms,
                          "sum_ms": scan_ms + excl_ms})
            del g, ge
    say("kernels", chunk_sweep=sweep)

    # K7: NB * full_sum - sum, 2^(c-1) = 2^k doublings; limb for limb
    # against the plain version (the same doubling formula), and in affine
    # form against the complete-add order (the JAX kernel's); an identity
    # on lane 0 of a and of b
    kd = shapes["nb_log2"]
    for lanes in (4 * W, 15 * W):
        a = tuple(c.clone() for c in proj(lanes))
        b = tuple(c.clone() for c in proj(lanes))
        for c, i in zip(a + b, G1.identity(dev) * 2):
            c[:, 0:1] = i
        out = kernels.ec_double_add(G1, a, b, kd)
        ref, plain_ms = cuda_once(
            lambda: kernels.ec_double_add_plain(G1, a, b, kd))
        ms = cuda_ms(lambda: kernels.ec_double_add(G1, a, b, kd), 5)
        chain = kd * DBL_MULS + ADD_MULS          # one thread a lane
        record("ec_double_add", f"(k={kd},lanes={lanes})", out, ref, ms,
               plain_ms, (3 * 72 * lanes * 4, lanes * (kd * EC_DBL + EC_ADD)),
               chain_muls=chain, us_per_chain_mul=ms * 1e3 / chain)
        err = max_abs_err(
            G1.affine(kernels.ec_double_add(G1, a, b, kd)),
            G1.affine(kernels.ec_double_add_plain(G1, a, b, kd,
                                                  doubling=False)))
        say("kernels", kernel="ec_double_add", case=f"(k={kd},lanes="
            f"{lanes})", max_abs_err_affine_vs_sequential=err)
        if err != 0:
            raise AssertionError(f"ec_double_add lanes={lanes}: not the "
                                 f"complete-add order's points ({err})")
        r = results["ec_double_add"]
        r["max_abs_err_affine_vs_sequential"] = max(
            err, r.get("max_abs_err_affine_vs_sequential", 0))

    # K8: the window combine of msm_device, W windows of c bits, on one
    # lane (msm_device's B = 1, timed first), on three lanes (T_0 the
    # identity on lane 0, T_1 = T_0 on lane 1, T_1 = -T_0 on lane 2) and on
    # eleven: three blocks of five lanes, where the spare team of the first
    # two reads a lane of the next block and the last block clamps.  Limb
    # for limb against the plain version (the kernel's order: from T_0, c
    # RCB15 doublings and one add a window), in affine form against the
    # complete-add order from the identity (the JAX kernel's).  The chain:
    # a team of six runs each doubling and add as two dependent multiplies
    c = shapes["window_bits"]
    chain = 2 * (c + 1) * (W - 1)
    chain_before = W * (c + 1) * ADD_MULS   # the one-thread complete-add order
    for lanes in (1, 3, 11):
        g = proj_steps(W, lanes)
        out = kernels.ec_combine(G1, g, c)
        ref, plain_ms = cuda_once(lambda: kernels.ec_combine_plain(G1, g, c))
        ms = cuda_ms(lambda: kernels.ec_combine(G1, g, c), 5)
        case = f"(W={W},c={c},lanes={lanes})"
        record("ec_combine", case, out, ref, ms, plain_ms,
               ((W + 1) * 72 * lanes * 4,
                lanes * ((W - 1) * (c * EC_DBL + EC_ADD))),
               chain_muls=chain, chain_muls_before=chain_before,
               us_per_chain_mul=ms * 1e3 / chain)
        err = max_abs_err(G1.affine(out), G1.affine(
            kernels.ec_combine_plain(G1, g, c, doubling=False)))
        say("kernels", kernel="ec_combine", case=case,
            max_abs_err_affine_vs_sequential=err)
        if err != 0:
            raise AssertionError(f"ec_combine {case}: not the complete-add "
                                 f"order's points ({err})")
        r = results["ec_combine"]
        r["max_abs_err_affine_vs_sequential"] = max(
            err, r.get("max_abs_err_affine_vs_sequential", 0))
    return results


def phase_small():
    """k = 7: the port against the host, both for host keys with the torch
    engine and for device setup + device key compilation."""
    import torch
    from dusk_plonk_torch.prelude import (
        ChaCha12Rng, PlonkKey, PlonkParams, compile_circuit_torch)
    Mixed = mixed_circuit()
    rng_h = ChaCha12Rng.seed_from_u64(8349)
    pp_h = PlonkParams.setup(7, rng_h)
    prover_h, verifier = PlonkKey.compile(pp_h, Mixed)
    proof_h, pis_h = prover_h.create_proof(rng_h, Mixed(13, 5))

    rng_t = ChaCha12Rng.seed_from_u64(8349)
    prover_t, _ = compile_circuit_torch(PlonkParams.setup(7, rng_t), Mixed(),
                                        "cuda")
    rng_d = ChaCha12Rng.seed_from_u64(8349)
    pp_d = PlonkParams.setup_device(7, rng_d)
    if pp_d.powers != pp_h.powers:
        raise AssertionError("k=7 setup_device powers differ from setup")
    prover_d, verifier_d = PlonkKey.compile_device(pp_d, Mixed)
    if (prover_d.verifier_key.to_bytes()
            != prover_h.verifier_key.to_bytes()):
        raise AssertionError("k=7 compile_device key differs from host")
    for name, prover, rng in (("torch", prover_t, rng_t),
                              ("device", prover_d, rng_d)):
        proof, pis = prover.create_proof(rng, Mixed(13, 5))
        torch.cuda.synchronize()
        for f in PROOF_FIELDS:
            if getattr(proof_h, f) != getattr(proof, f):
                raise AssertionError(
                    f"k=7 {name} proof differs from host at {f}")
        if pis_h != pis or proof.to_bytes() != proof_h.to_bytes():
            raise AssertionError(f"k=7 {name} proof bytes differ")
        verifier.verify(proof, pis)
        verifier_d.verify(proof, pis)
    say("small", k=7, setup_device_equal=True, compile_device_equal=True,
        proofs_equal_to_host=True, verified=True,
        timings=prover_d.engine.last_timings)


def spot_check_srs(pp, tau, count, seed):
    """`count` random SRS powers against the host's tau^i G."""
    import numpy as np
    from dusk_plonk_torch.curves import bls
    from dusk_plonk_torch.fields.constants import R_MOD
    idx = np.random.default_rng(seed).choice(len(pp.powers), count,
                                              replace=False)
    for i in map(int, idx):
        if pp.powers[i] != bls.g1_mul(bls.G1_GENERATOR,
                                      pow(tau, i, R_MOD)):
            raise AssertionError(f"SRS power {i} differs from tau^i G")
    return sorted(map(int, idx))


# each kernel's launches a default 2^16 proof; phase full fails if they
# move.  K2 makes one launch a pass: of the proof's five transforms, the
# (6, 2^19) coset_dft and the (1, 2^19) coset_idft take three passes, the
# (4, 2^16) and two (1, 2^16) idfts two: 12 launches where the stage
# kernel made 86.  The pre- and post-scales ride in those passes, so K1
# lost its two launches a transform (798 - 10).
# K14 took the quotient's multiplies: its 115 on the grid, its 13
# challenge products and round 3's 7 challenge packs (788 - 135).
LAUNCHES_PER_PROOF = {"mont_mul": 653, "ntt": 12, "ec_add": 4,
                      "ec_scan_mixed": 4, "ec_sum_steps": 8,
                      "ec_scan_excl": 4, "ec_double_add": 4, "quotient": 1}


# each kernel's C entry point, and from its arguments (as the wrappers of
# ops/kernels.py pass them) the launch's class, its shape, and its work:
# (bytes it must move, each input read once and each output written once;
# 32-bit multiplies), as phase_kernels counts them
def _mont_mul_launch(a):
    L, sa_row, sa_elem, sb_row, sb_elem, rows, n = (a[0], a[2], a[4], a[6],
                                                   a[8], a[10], a[11])
    elems = sum((rows if r else 1) * (n if e else 1)
                for r, e in ((sa_row, sa_elem), (sb_row, sb_elem)))
    return (f"{'Fr' if L == 16 else 'Fq'}(rows={rows},n={n})",
            ((elems + rows * n) * L * 4,
             rows * n * (FR_MUL if L == 16 else FQ_MUL)))


def _ntt_launch(a):
    batch, k, log_m, pre, post = a[5], a[6], a[7], a[16], a[17]
    n = 1 << k
    return (f"(batch={batch},k={k},log_m={log_m})",
            (2 * batch * 16 * n * 4 + 32 * n * (pre + (post > 1)),
             batch * (n // 2 * log_m + n * (pre + (post > 0))) * FR_MUL))


def _steps_launch(a, work):
    steps, lanes, T, m = a[6], a[7], a[8], a[9]
    return f"(steps={steps},lanes={lanes},block=({T},{m}))", \
        work(steps, lanes)


LAUNCH_CLASSES = {
    "mont_mul": ("dt_mont_mul", _mont_mul_launch),
    "ntt": ("dt_ntt_pass", _ntt_launch),
    "ec_add": ("dt_ec_add", lambda a: (
        f"lanes={a[9] * a[10]}",
        (9 * 24 * a[9] * a[10] * 4, a[9] * a[10] * EC_ADD))),
    "ec_add_mixed": ("dt_ec_add_mixed", lambda a: (
        f"lanes={a[8] * a[9]}",
        (8 * 24 * a[8] * a[9] * 4, a[8] * a[9] * EC_ADD_MIXED))),
    "ec_scan_mixed": ("dt_ec_scan_mixed", lambda a: (
        f"(cl={a[4]},48,lanes={a[5]})",
        (a[4] * a[5] * (48 + 72) * 4, a[4] * a[5] * EC_ADD_MIXED))),
    "ec_scan_mixed_em": ("dt_ec_scan_mixed_em", lambda a: (
        f"(cl={a[2]},48,lanes={a[3]},team={a[4]})",
        (a[2] * a[3] * (48 + 72) * 4, a[2] * a[3] * EC_ADD_MIXED))),
    "ec_sum_steps": ("dt_ec_sum_steps", lambda a: _steps_launch(
        a, lambda s, l: ((s + 1) * 72 * l * 4, s * l * EC_ADD))),
    "ec_scan_excl": ("dt_ec_scan_excl", lambda a: _steps_launch(
        a, lambda s, l: (2 * s * 72 * l * 4, (s - 1) * l * EC_ADD))),
    "ec_double_add": ("dt_ec_double_add", lambda a: (
        f"(k={a[9]},lanes={a[10]})",
        (3 * 72 * a[10] * 4, a[10] * (a[9] * EC_DBL + EC_ADD)))),
    "ec_combine": ("dt_ec_combine", lambda a: (
        f"(W={a[6]},c={a[7]},lanes={a[8]})",
        ((a[6] + 1) * 72 * a[8] * 4,
         a[8] * (a[6] - 1) * (a[7] * EC_DBL + EC_ADD)))),
    "reduce_planes": ("dt_reduce_planes", lambda a: (
        f"(rows={a[2]},65,n={a[3]})",
        (a[2] * a[3] * (65 + 16) * 4, a[2] * a[3] * REDUCE_PLANES))),
    "quotient": ("dt_quotient", lambda a: (
        f"E={a[9]}", quotient_work(a[9], a[10]))),
}


class LaunchLog:
    """Wraps the C entry points of `names` (default: every kernel) so that
    each launch is logged as (kernel, class, args, work, start, end), with
    CUDA events on the launch stream around it when `timed`.  A context
    manager: the entry points are restored on exit.  The package's own
    launch counters are untouched."""

    def __init__(self, names=tuple(LAUNCH_CLASSES), timed=False):
        self.names = names
        self.timed = timed
        self.entries = []
        self._saved = {}

    def __enter__(self):
        import torch
        from dusk_plonk_torch.ops import _build
        self._lib = lib = _build.lib()
        for name in self.names:
            attr, classify = LAUNCH_CLASSES[name]
            entry = getattr(lib, attr)
            self._saved[attr] = entry

            def logged(*args, name=name, entry=entry, classify=classify):
                cls, work = classify(args)
                ev = None
                if self.timed:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                rc = entry(*args)
                if ev:
                    ev[1].record()
                self.entries.append((name, cls, args, work, ev))
                return rc
            setattr(lib, attr, logged)
        return self

    def __exit__(self, *exc):
        for attr, entry in self._saved.items():
            setattr(self._lib, attr, entry)

    def classes(self, name=None, start=0):
        """Counter of the launches from entry `start` on by class (of
        kernel `name`) or by (kernel, class)."""
        return collections.Counter(
            cls if name else (k, cls) for k, cls, *_ in
            self.entries[start:] if name in (None, k))

    def ms(self, i):
        """Device ms of logged launch i (timed logs, after a sync)."""
        start, end = self.entries[i][4]
        return start.elapsed_time(end)

    def table(self, rate, start=0):
        """Per (kernel, class) from entry `start` on: launches, their
        bounds summed (phase_kernels' formula; launches of one class may
        move other bytes, as K1 with a broadcast operand), and for a timed
        log the device ms summed; each also a launch."""
        rows = {}
        for i in range(start, len(self.entries)):
            k, cls, _, work, ev = self.entries[i]
            b_ms, b_by = bound(*work, rate)
            r = rows.setdefault((k, cls), {
                "kernel": k, "class": cls, "launches": 0, "bound_ms": 0.0,
                "bound_by": b_by})
            r["launches"] += 1
            r["bound_ms"] += b_ms
            if ev:
                r["ms"] = r.get("ms", 0.0) + self.ms(i)
        for r in rows.values():
            for key in ("ms", "bound_ms"):
                if key in r:
                    r[key + "_a_launch"] = r[key] / r["launches"]
        return list(rows.values())


def phase_full(k):
    """bench.py's proof path: device setup, device key compilation, one
    warm and two timed proofs.  Each path's kernel launches are counted
    from 0 just before it; K1's launches of the proofs also by (field,
    rows, n) class."""
    import torch
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.prelude import (
        ChaCha12Rng, PlonkKey, PlonkParams, fr_random)
    Bench = bench_circuit(k)
    counts = {}
    tau = fr_random(ChaCha12Rng.seed_from_u64(8349))   # setup's one draw
    rng = ChaCha12Rng.seed_from_u64(8349)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pp = PlonkParams.setup_device(k, rng)
    t1 = time.perf_counter()
    counts["setup"] = kernels.launch_counts()
    checked = spot_check_srs(pp, tau, 16, k)
    kernels.reset_launches()
    t2 = time.perf_counter()
    prover, verifier = PlonkKey.compile_device(pp, Bench)
    t3 = time.perf_counter()
    counts["compile"] = kernels.launch_counts()
    engine = prover.engine
    say("full", k=k, setup_s=t1 - t0, setup_steps=pp.setup_timings,
        srs_spot_checked=checked, compile_s=t3 - t2,
        compile_steps=engine.compile_timings,
        commit15_peak_gb=engine.compile_peaks["commit15"] / 2 ** 30,
        ns=engine.ns, n8=engine.n8, launches_setup=counts["setup"],
        launches_compile=counts["compile"])

    with LaunchLog(("mont_mul",)) as log:
        kernels.reset_launches()
        proof, pis = prover.create_proof(rng, Bench(3))        # warm
        warm = dict(engine.last_timings)
        peak = max(engine.last_peaks.values())
        verifier.verify(proof, pis)
        times, rounds = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            proof, pis = prover.create_proof(rng, Bench(3))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rounds.append(dict(engine.last_timings))
            peak = max(peak, *engine.last_peaks.values())
        counts["proof"] = kernels.launch_counts()
    classes = log.classes("mont_mul")
    if sum(classes.values()) != counts["proof"]["mont_mul"]:
        raise AssertionError("mont_mul classes do not add up to its count")
    t0 = time.perf_counter()
    verifier.verify(proof, pis)
    verify_s = time.perf_counter() - t0
    best = min(range(2), key=lambda i: times[i])
    say("full", k=k, proof_s=times, best_s=times[best],
        rounds_best=rounds[best], rounds_warm=warm, verified=True,
        verify_s=verify_s, launches_proof=counts["proof"],
        mont_mul_per_proof_by_class={c: v / 3
                                     for c, v in classes.most_common()},
        mont_mul_per_proof=counts["proof"]["mont_mul"] / 3,
        launches_per_proof_expected=LAUNCHES_PER_PROOF,
        peak_mem_gb=peak / 2 ** 30)
    need = {"setup": ("ec_add",),
            "compile": ("mont_mul", "ntt", "ec_add", "ec_scan_mixed",
                        "ec_sum_steps", "ec_scan_excl", "ec_double_add"),
            "proof": ("mont_mul", "ntt", "ec_add", "ec_scan_mixed",
                      "ec_sum_steps", "ec_scan_excl", "ec_double_add",
                      "quotient")}
    missing = [(path, name) for path, names in need.items()
               for name in names if counts[path][name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    moved = {name: counts["proof"][name] / 3
             for name, want in LAUNCHES_PER_PROOF.items()
             if counts["proof"][name] != 3 * want}

    # a fourth proof, its K14 arguments kept
    capture = ShapeCapture(("quotient",))
    with capture:
        proof, pis = prover.create_proof(rng, Bench(3))
    verifier.verify(proof, pis)
    (args,) = capture.kept.values()
    k14 = check_quotient(args)
    if moved:
        raise AssertionError(f"launches a proof moved: {moved}")
    return counts, (pp, prover, verifier), k14


def check_quotient(args, phase="full", reps=20):
    """K14 on one proof's round-3 arguments: against its plain version
    limb for limb at the full width with K1 multiplies, on the last 2^16
    columns (the next gate wrapping to the coset's first 8) with K1's
    plain multiply, and on the first 32 and the first 1,000 columns (the
    smallest shard, and a ragged edge: 1,000 is no multiple of a block's
    32 points) with their next 8 as the halo; the full-width time through
    the wrapper and at the C entry (median of 5 x `reps` launches), the
    plain chain's time, the bound, and the kernel's registers and spills,
    on `phase`'s line.  Returns its record for the kernels line."""
    from dusk_plonk_torch.ops import _build, kernels
    F, evs, halo = args[:3]
    E = evs.shape[-1]
    out = kernels.quotient(*args)
    ref, plain_ms = cuda_once(lambda: kernels.quotient_plain(*args,
                                                             mul=F.mul))
    launch, raw = quotient_entry(args)
    ms, runs = cuda_ms_runs(launch, reps)
    wrapper_ms, wrapper_runs = cuda_ms_runs(lambda: kernels.quotient(*args),
                                            reps)
    err = max_abs_err((out, raw), (ref, ref))
    m = 1 << 16
    tail = (F, evs[..., -m:].contiguous(),
            evs[[0, 1, 2, 4], :, :8].contiguous()) + tuple(
                x[..., -m:].contiguous() for x in args[3:-1]) + args[-1:]
    out_t = kernels.quotient(*tail)
    ref_t, plain_tail_ms = cuda_once(lambda: kernels.quotient_plain(*tail))
    err_tail = max_abs_err((out_t, out_t), (ref_t, out[..., -m:]))
    err_head = {}
    for e in (32, 1000):
        head = (F, evs[..., :e].contiguous(),
                evs[[0, 1, 2, 4], :, e:e + 8].contiguous()) + tuple(
                    x[..., :e].contiguous() for x in args[3:-1]) + args[-1:]
        out_h = kernels.quotient(*head)
        err_head[e] = max_abs_err((out_h, out_h),
                                  (kernels.quotient_plain(*head),
                                   out[..., :e]))
    bound_ms, bound_by = bound(*quotient_work(E, args[-1].shape[-1]),
                               int_mul_rate())
    # the bound under the one-thread design's count, for comparison
    one_thread_ms, _ = bound(*quotient_work(
        E, args[-1].shape[-1], QUOTIENT_MULS_ONE_THREAD * FR_MUL),
        int_mul_rate())
    ptxas = [v for k, v in ptxas_table(_build.BUILD_LOG).items()
             if PTXAS_FOCUS["K14"] in k]
    if not ptxas:
        raise AssertionError("quotient: no ptxas line for "
                             f"{PTXAS_FOCUS['K14']}")
    rec = {"max_abs_err": max(err, err_tail, *err_head.values()),
           "case": f"(16,{E})", "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    say(phase, kernel="quotient", case=rec["case"], max_abs_err=err,
        ms=ms, ms_runs=runs, wrapper_ms=wrapper_ms,
        wrapper_ms_runs=wrapper_runs, plain_ms=plain_ms,
        plain_mul="K1", bound_ms=bound_ms, bound_by=bound_by,
        muls_an_element=QUOTIENT_MULS, products_a_mul=FR_MUL_SHAPED,
        bound_ms_one_thread_count=one_thread_ms,
        ptxas=ptxas, tail_case=f"(16,{m}) wrapping",
        max_abs_err_tail=err_tail, plain_tail_ms=plain_tail_ms,
        plain_tail_mul="K1 plain",
        max_abs_err_first_columns={f"(16,{e})": v
                                   for e, v in err_head.items()})
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"quotient: kernel != plain ({err}, tail "
                             f"{err_tail}, first columns {err_head})")
    return rec


def phase_msm(phase="msm", need=("ec_combine",)):
    """bench.py's MSM metric: msm_device on 2^16 seeded points (tau^i G of
    a seeded device setup) and seeded scalars, best of 3, equal to the
    host C++ MSM, under the config the caller set.  Returns (the launch
    counts, the best time in s)."""
    import numpy as np
    import torch
    from dusk_plonk_torch import native
    from dusk_plonk_torch.fields.constants import R_MOD
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.ops.ec import device_g1
    from dusk_plonk_torch.ops.limb import fr_field
    from dusk_plonk_torch.ops.msm import MsmPlan
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkParams
    n = 1 << K
    pp = PlonkParams.setup_device(K, ChaCha12Rng.seed_from_u64(99))
    points = tuple(c[:, :n].contiguous() for c in pp.packed)
    rng = np.random.default_rng(8349)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD
               for _ in range(n)]
    limbs = fr_field().pack(scalars, "cuda", to_mont=False)
    plan = MsmPlan(n)
    em = plan.prepare_points(points)
    plan.msm_device(em, limbs)                                 # warm
    kernels.reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = plan.msm_device(em, limbs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    got = device_g1().to_affine(out)[0]
    if got != native.g1_msm(pp.powers[:n], scalars):
        raise AssertionError(f"{phase}: msm_device differs from the host "
                             f"MSM")
    best = min(times)
    say(phase, n=n, scan_em=plan.scan_em, times_s=times, best_s=best,
        points_per_s=n / best, equal_to_host=True,
        launches=counts)
    missing = [name for name in need if counts[name] == 0]
    if missing:
        raise AssertionError(f"{phase}: never launched by msm_device: "
                             f"{missing}")
    return counts, best


def phase_alt(k):
    """The JAX package's switched-off configuration at 2^k: one device
    setup, a key and a proof under the default config, then under
    ntt_mxu_min_k = k and ec_scan_em a key (equal verification key bytes)
    and three proofs from the same seed (each equal to the default proof
    byte for byte, verified), msm_device at 2^16, and the JAX MSM's
    per-step scan route at 2^10 points (K10).  Each path's launches are
    counted from 0 just before it; the default config is restored at the
    end."""
    import torch
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.ops.ec import device_g1
    from dusk_plonk_torch.ops.msm import MsmPlan
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkKey, PlonkParams
    from dusk_plonk_torch.utils import config
    Bench = bench_circuit(k)
    pp = PlonkParams.setup_device(k, ChaCha12Rng.seed_from_u64(8349))
    prover, verifier = PlonkKey.compile_device(pp, Bench)
    vk = prover.verifier_key.to_bytes()
    ref, ref_pis = prover.create_proof(ChaCha12Rng.seed_from_u64(77),
                                       Bench(3))
    ref_bytes = ref.to_bytes()
    del prover
    counts = {}
    old = config.get_config()
    try:
        config.set_config(ntt_mxu_min_k=k, ec_scan_em=True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        prover, verifier_a = PlonkKey.compile_device(pp, Bench)
        compile_s = time.perf_counter() - t0
        counts["compile"] = kernels.launch_counts()
        engine = prover.engine
        if not (engine.plan_n.mxu and engine.plan_8n.mxu
                and engine.msm.scan_em):
            raise AssertionError("alt: the plans did not take the "
                                 "switched-off routes")
        if prover.verifier_key.to_bytes() != vk:
            raise AssertionError("alt: verification key differs from the "
                                 "default config's")
        kernels.reset_launches()
        times, rounds, k12 = [], [], []
        with LaunchLog(("ec_scan_mixed_em",), timed=True) as log:
            for i in range(3):                      # the first is warm
                first = len(log.entries)
                t0 = time.perf_counter()
                proof, pis = prover.create_proof(
                    ChaCha12Rng.seed_from_u64(77), Bench(3))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                rounds.append(dict(engine.last_timings))
                k12.append([(log.entries[j][2][3], log.entries[j][2][4],
                             log.ms(j))
                            for j in range(first, len(log.entries))])
                if proof.to_bytes() != ref_bytes or pis != ref_pis:
                    raise AssertionError(f"alt: proof {i} differs from the "
                                         f"default config's")
        counts["proof"] = kernels.launch_counts()
        verifier.verify(proof, pis)
        verifier_a.verify(proof, pis)
        best = min((1, 2), key=lambda i: times[i])
        k12_ms = [sum(ms for _, _, ms in k12[i]) for i in (1, 2)]
        say("alt", k=k, compile_s=compile_s,
            compile_steps=engine.compile_timings, vk_equal=True,
            proofs_equal_to_default=True, verified=True, proof_s=times[1:],
            warm_s=times[0], best_s=times[best], rounds_best=rounds[best],
            rounds_warm=rounds[0], launches_compile=counts["compile"],
            launches_proof=counts["proof"], k12_ms_a_proof=k12_ms,
            k12_launches_best=k12[best])
        on = ("mont_mul", "ec_add", "ec_scan_mixed_em", "ec_sum_steps",
              "ec_scan_excl", "ec_double_add", "reduce_planes")
        off = ("ntt", "ec_scan_mixed")
        bad = [(path, name) for path in ("compile", "proof")
               for name in on if counts[path][name] == 0] + \
              [(path, name) for path in ("compile", "proof")
               for name in off if counts[path][name] != 0]
        if bad:
            raise AssertionError(f"alt: launches off their routes: {bad}")
        del prover, engine
        counts["msm"], msm_s = phase_msm("alt_msm", ("ec_scan_mixed_em",
                                                     "ec_combine"))
        say("alt", k12_ms_a_proof=k12_ms, msm_device_ms=msm_s * 1e3)
        if counts["msm"]["ec_scan_mixed"]:
            raise AssertionError("alt_msm: K11a launched under ec_scan_em")
    finally:
        config.set_config(ntt_mxu_min_k=old.ntt_mxu_min_k,
                          ec_scan_em=old.ec_scan_em)

    # the JAX MSM's per-step scan route (ops/msm.py:297-304), taken when
    # its scan lanes are no multiple of 128: W nc lanes of a 2^10-point
    # MSM, one DeviceG1.add_mixed (K10) launch a step, held against the
    # K11a scan of the same steps
    G1 = device_g1()
    plan = MsmPlan(1 << 10)
    cl, lanes = plan.chunk_len, plan.num_windows * (plan.n_pad
                                                   // plan.chunk_len)
    gen = torch.Generator().manual_seed(10)
    idx = torch.randint(0, pp.packed[0].shape[-1], (cl * lanes,),
                        generator=gen).to("cuda")
    g = torch.cat([pp.packed[0][:, idx], pp.packed[1][:, idx]]).reshape(
        48, cl, lanes).permute(1, 0, 2).contiguous()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    acc = G1.broadcast_identity((), lanes, "cuda")
    for step in range(cl):
        acc = G1.add_mixed(acc, (g[step, :24], g[step, 24:]))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts["step_scan"] = kernels.launch_counts()
    err = max_abs_err(acc, tuple(c[-1] for c in G1.scan_mixed(g)))
    say("alt", step_scan=f"(cl={cl},24,lanes={lanes})", wall_s=step_s,
        max_abs_err_vs_scan=err, launches=counts["step_scan"])
    if err != 0 or counts["step_scan"]["ec_add_mixed"] != cl:
        raise AssertionError("alt: the per-step scan route is wrong")
    return counts


def msm_plan_under(n, **overrides):
    """MsmPlan(n) built under `overrides` of the config, restored after."""
    from dusk_plonk_torch.ops.msm import MsmPlan
    from dusk_plonk_torch.utils import config
    old = config.get_config()
    config.set_config(**overrides)
    try:
        return MsmPlan(n)
    finally:
        config.set_config(**{k: getattr(old, k) for k in overrides})


# the kernels each path of phase large must launch
LARGE_NEED = {"setup": ("mont_mul", "ec_add"),
              "compile": ("mont_mul", "ntt", "ec_add", "ec_scan_mixed",
                          "ec_sum_steps", "ec_scan_excl", "ec_double_add"),
              "proof": ("mont_mul", "ntt", "ec_add", "ec_scan_mixed",
                        "ec_sum_steps", "ec_scan_excl", "ec_double_add",
                        "quotient")}


def phase_large(k):
    """bench.py's 2^20 path (bench.py::_maybe_bench_2e20) with the SRS made
    by the device setup (no cached SRS file): setup_device (16 powers
    spot-checked), compile_device, one warm and one timed proof, each
    verified on the host verifier.  Per-step wall times and peak GiB, the
    MSM's row groups of each commit batch, and every kernel launch by
    kernel and shape class for setup, compile and the timed proof, each
    class with its device ms (CUDA events around each launch) and its
    launches' summed bound.  Then a third proof whose K14 arguments are
    kept and held against K14's plain version at (16, 2^(k+3))
    (check_quotient, after the timed proof so that its time and peak
    carry no copies).  Then key compilation's 15-commit batch in one
    row group, which must run out of device memory (the fault the cap
    repairs), and one 2^k commitment under the default cap and under a cap
    of one row a group, equal in affine form, and against the host C++
    MSM."""
    import torch
    from dusk_plonk_torch import native
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.ops.limb import fr_field
    from dusk_plonk_torch.prelude import (
        ChaCha12Rng, PlonkKey, PlonkParams, fr_random)
    torch.cuda.empty_cache()
    rate = int_mul_rate()

    def gb(peaks):
        return {step: v / 2 ** 30 for step, v in peaks.items()}

    Bench = bench_circuit(k)
    counts, tables, wall = {}, {}, {}

    def logged(path, fn):
        with LaunchLog(timed=True) as log:
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall[path] = time.perf_counter() - t0
            counts[path] = kernels.launch_counts()
        tables[path] = log.table(rate)
        return out

    tau = fr_random(ChaCha12Rng.seed_from_u64(8349))   # setup's one draw
    rng = ChaCha12Rng.seed_from_u64(8349)
    pp = logged("setup", lambda: PlonkParams.setup_device(k, rng))
    t0 = time.perf_counter()
    checked = spot_check_srs(pp, tau, 16, k)
    spot_s = time.perf_counter() - t0
    prover, verifier = logged("compile",
                              lambda: PlonkKey.compile_device(pp, Bench))
    engine = prover.engine
    msm = engine.msm
    groups = {f"B={B}": [b - a for a, b in
                         msm._row_groups(B * msm.num_windows)]
              for B in (15, 4, 1, 2)}
    say("large", gpu=nvidia_smi_line(), k=k, setup_s=wall["setup"],
        setup_steps=pp.setup_timings, setup_peak_gb=gb(pp.setup_peaks),
        srs_spot_checked=checked, spot_check_s=spot_s,
        compile_s=wall["compile"], compile_steps=engine.compile_timings,
        compile_peak_gb=gb(engine.compile_peaks),
        commit15_peak_gb=engine.compile_peaks["commit15"] / 2 ** 30,
        ns=engine.ns, n8=engine.n8, n_pad=msm.n_pad,
        window_bits=msm.window_bits, windows=msm.num_windows,
        chunks=msm.n_pad // msm.chunk_len, group_slots=msm.group_slots,
        row_groups=groups, launches_setup=counts["setup"],
        launches_compile=counts["compile"],
        launch_classes_setup=tables["setup"],
        launch_classes_compile=tables["compile"])

    t0 = time.perf_counter()
    proof, pis = prover.create_proof(rng, Bench(3))            # warm
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = (dict(engine.last_timings), gb(engine.last_peaks))
    verifier.verify(proof, pis)
    proof, pis = logged("proof", lambda: prover.create_proof(rng, Bench(3)))
    t0 = time.perf_counter()
    verifier.verify(proof, pis)
    verify_s = time.perf_counter() - t0
    say("large", k=k, proof_s=wall["proof"], warm_s=warm_s,
        rounds=engine.last_timings, rounds_warm=warm[0],
        peak_gb=gb(engine.last_peaks), peak_gb_warm=warm[1],
        verified=True, verify_s=verify_s, launches_proof=counts["proof"],
        launch_classes_proof=tables["proof"])
    missing = [(path, name) for path, names in LARGE_NEED.items()
               for name in names if counts[path][name] == 0]
    if missing:
        raise AssertionError(f"large: kernels never launched on their "
                             f"path: {missing}")

    # K14 at the 2^20 proof's own shape and data
    capture = ShapeCapture(("quotient",))
    with capture:
        proof, pis = prover.create_proof(rng, Bench(3))
    verifier.verify(proof, pis)
    (args,) = capture.kept.values()
    k14 = check_quotient(args, "large", reps=2)
    del args, capture
    torch.cuda.empty_cache()

    # the fault the cap repairs: key compilation's batch of 15 commits (300
    # rows) in one group does not fit on the card
    Fr = fr_field()
    gen = torch.Generator().manual_seed(k)
    stack = rand_limbs(gen, Fr, (15, engine.ns), "cuda")
    uncapped = msm_plan_under(engine.ns, msm_group_slots=1 << 62)
    oom = None
    try:
        uncapped.window_totals(engine.srs_em, stack)
    except torch.OutOfMemoryError as e:
        oom = ". ".join(str(e).split(". ")[:2])
    del stack
    torch.cuda.empty_cache()
    if oom is None:
        raise AssertionError("large: 15 commits in one group fit the card")
    say("large", uncapped_rows=15 * uncapped.num_windows,
        uncapped_groups=len(uncapped._row_groups(15 * uncapped.num_windows)),
        uncapped_out_of_memory=oom)

    # one commitment of seeded scalars to the 2^k + 7 SRS points: the
    # default cap (the batch's W rows in one group) against one row a group
    lim = rand_limbs(gen, Fr, (engine.ns,), "cuda")[None]
    t0 = time.perf_counter()
    default = msm.msm_affine_batch(engine.srs_em, lim)[0]
    default_s = time.perf_counter() - t0
    one_row = msm_plan_under(engine.ns, msm_group_slots=msm.n_pad)
    t0 = time.perf_counter()
    single = one_row.msm_affine_batch(engine.srs_em, lim)[0]
    single_s = time.perf_counter() - t0
    if default != single:
        raise AssertionError("large: the commitment depends on the row "
                             "groups")
    scalars = Fr.unpack(lim[0], from_mont=False)
    t0 = time.perf_counter()
    host = native.g1_msm(pp.powers[:engine.ns], scalars)
    host_s = time.perf_counter() - t0
    if host != default:
        raise AssertionError("large: the commitment differs from the host "
                             "C++ MSM")
    say("large", commit_points=engine.ns,
        row_groups_default=[b - a for a, b in
                            msm._row_groups(msm.num_windows)],
        row_groups_one_row=[b - a for a, b in
                            one_row._row_groups(one_row.num_windows)],
        commit_default_s=default_s, commit_one_row_s=single_s,
        equal_across_groups=True, host_msm_s=host_s, equal_to_host=True)
    del prover, verifier, engine, pp
    torch.cuda.empty_cache()
    return counts, k14


def wide_circuit():
    """tests/test_sharded_engine.py's circuit: > 32 gates, so n = 64 and
    both domains take the four-step route at D = 8."""
    from dusk_plonk_torch.prelude import Circuit, Constraint

    class WideCircuit(Circuit):
        def __init__(self, a=3):
            self.a = a

        def synthesize(self, c):
            w = c.append_witness(self.a)
            c.component_boolean(c.append_witness(1))
            acc = w
            for _ in range(40):
                acc = c.gate_mul(Constraint().mult(1).a(acc).b(w))

    return WideCircuit


def _routes(engine):
    d = engine.D
    return {dom: "four-step" if (1 << k) % (d * d) == 0 else "fallback"
            for dom, k in (("n", engine.k), ("8n", engine.k8))}


def sharded_small(name, circuit, args, d, rate, capture):
    """A k = 7 SRS, host keys: the ShardedEngine's proof on d shards of
    cuda:0 against the host oracle's from the same seed, under `capture`
    (a ShapeCapture), whose kernels are then held against their plain
    versions at each shape not yet held."""
    import torch
    from dusk_plonk_torch.parallel.mesh import Mesh
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkKey, PlonkParams
    from dusk_plonk_torch.proving.sharded_engine import ShardedEngine
    rng_h = ChaCha12Rng.seed_from_u64(8349)
    prover_h, verifier = PlonkKey.compile(PlonkParams.setup(7, rng_h),
                                          circuit)
    proof_h, pis_h = prover_h.create_proof(rng_h, circuit(*args))
    rng = ChaCha12Rng.seed_from_u64(8349)
    prover, _ = PlonkKey.compile(PlonkParams.setup(7, rng), circuit)
    engine = ShardedEngine(prover, mesh=Mesh(["cuda:0"] * d))
    prover.use_device_engine(engine)
    t0 = time.perf_counter()
    with capture:
        proof, pis = prover.create_proof(rng, circuit(*args))
    torch.cuda.synchronize()
    proof_s = time.perf_counter() - t0
    if pis != pis_h or proof.to_bytes() != proof_h.to_bytes():
        raise AssertionError(f"sharded {name} d={d}: proof differs from "
                             f"the host oracle's")
    verifier.verify(proof, pis)
    say("sharded", circuit=name, d=d, n=engine.n, n8=engine.n8,
        ns=engine.ns, nsd=engine.nsd, routes=_routes(engine),
        equal_to_host=True, verified=True, proof_s=proof_s)
    capture.check(rate, d=d, path=f"{name} circuit")


def _arg_sig(x):
    """The shape signature of a wrapper argument: tensors by shape and
    strides, fields and groups by limb count, tables' passes by value."""
    import torch
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.stride()
    if isinstance(x, (tuple, list)):
        return tuple(_arg_sig(v) for v in x)
    if x is None or isinstance(x, (int, str)) or dataclasses.is_dataclass(x):
        return x
    return type(x).__name__, getattr(x, "L", None)


def _arg_copy(x):
    """A copy of a wrapper argument that keeps every tensor's strides (a
    broadcast operand stays broadcast), so the copy launches as the
    original did."""
    import torch
    if isinstance(x, torch.Tensor):
        if x.numel() == 0:
            return x.clone()
        span = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
        return x.as_strided((span,), (1,)).clone().as_strided(
            x.shape, x.stride())
    if isinstance(x, tuple):
        return tuple(_arg_copy(v) for v in x)
    if isinstance(x, list):
        return [_arg_copy(v) for v in x]
    return x


def _plain_versions():
    """Each kernel wrapper a proof reaches -> its plain version in the
    kernel's own order (the CPU route's), so the two agree limb for
    limb."""
    from dusk_plonk_torch.ops import kernels as kn
    return {
        "mont_mul": kn.mont_mul_plain, "ntt": kn.ntt_plain,
        "ec_add": kn.ec_add_plain, "ec_scan_mixed": kn.ec_scan_mixed_plain,
        "ec_sum_steps": lambda G1, g: kn.ec_sum_steps_plain(
            G1, g, kn._sum_block(g[0].shape[0], g[0].shape[-1])),
        "ec_scan_excl": lambda G1, g: kn.ec_scan_excl_plain(
            G1, g, kn._excl_block(g[0].shape[0])),
        "ec_double_add": kn.ec_double_add_plain,
        "ec_combine": kn.ec_combine_plain, "quotient": kn.quotient_plain}


class _KernelsProxy:
    """Stands for the `kernels` module in the modules that launch: the
    wrappers in `hooks`, everything else the module's own."""

    def __init__(self, real, hooks):
        self.__dict__.update(hooks)
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)


class ShapeCapture:
    """While active, keeps a copy of the arguments of the first call of
    each kernel wrapper (`_plain_versions`, or the `names` given) at each
    argument shape that no earlier `check` has held: ops/limb.py,
    ops/ntt.py, ops/ec.py and the two engines, the modules that launch
    every kernel of a proof, see a proxy of `kernels` in place of the
    module.  The wrappers and their launch counters are
    untouched.  `check(rate)` then runs each kernel on its kept arguments
    and holds the result against its plain version limb for limb: every
    kernel at every shape the captured path launched, on the path's own
    data."""

    def __init__(self, names=None):
        self.names = names or tuple(_plain_versions())
        self.kept, self.done, self.errs = {}, set(), {}

    def __enter__(self):
        from dusk_plonk_torch.ops import ec, kernels, limb, ntt
        from dusk_plonk_torch.proving import engine, sharded_engine
        self._mods = (ec, limb, ntt, engine, sharded_engine)
        hooks = {}
        for name in self.names:
            def kept(*args, name=name, fn=getattr(kernels, name)):
                key = (name, _arg_sig(args))
                if key not in self.kept and key not in self.done:
                    self.kept[key] = _arg_copy(args)
                return fn(*args)
            hooks[name] = kept
        proxy = _KernelsProxy(kernels, hooks)
        for mod in self._mods:
            mod.kernels = proxy
        return self

    def __exit__(self, *exc):
        from dusk_plonk_torch.ops import kernels
        for mod in self._mods:
            mod.kernels = kernels

    def check(self, rate, **case):
        """Hold each kept call's kernel against its plain version (one
        line each); raises on the first disagreement.  Launches made here
        add to the wrappers' counters: read those before."""
        from dusk_plonk_torch.ops import kernels
        plain = _plain_versions()
        for key, args in self.kept.items():
            name = key[0]
            fn = getattr(kernels, name)
            with LaunchLog((name,)) as log:
                out = fn(*args)
            ref, plain_ms = cuda_once(lambda: plain[name](*args))
            err = max_abs_err(out, ref)
            work = [sum(w[i] for *_, w, _ in log.entries) for i in (0, 1)]
            bound_ms, bound_by = bound(*work, rate)
            say("sharded", kernel=name, **case,
                shape="; ".join(cls for _, cls, *_ in log.entries),
                max_abs_err=err, ms=cuda_ms(lambda: fn(*args), 5),
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            if err != 0:
                raise AssertionError(f"sharded {name} {case}: kernel != "
                                     f"plain ({err}) at {key[1]}")
            self.errs[name] = max(self.errs.get(name, 0), err)
            self.done.add(key)
        self.kept = {}


def sharded_bench(k, key, d, ref, rate, capture):
    """The 2^k bench circuit's proof on d shards of cuda:0 from phase
    full's device key: a warm and two timed proofs, each equal to the
    single-device engine's `ref` (proof, public inputs) from seed 77 and
    verified; the warm proof under `capture` (a ShapeCapture), whose
    kernels are held against their plain versions at every shape not yet
    held before the timed proofs.  Returns the launches of a timed proof
    by kernel."""
    import torch
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.parallel.mesh import Mesh
    from dusk_plonk_torch.parallel.model import proof_collective_bytes
    from dusk_plonk_torch.prelude import ChaCha12Rng
    from dusk_plonk_torch.proving.sharded_engine import ShardedEngine
    from dusk_plonk_torch.utils.tracing import tracer
    Bench = bench_circuit(k)
    _, prover, verifier = key
    single = prover.engine
    t0 = time.perf_counter()
    engine = ShardedEngine(
        prover, mesh=Mesh(["cuda:0"] * d), sel_polys=single.sel_polys,
        sigma_polys=single.sigma_polys, srs=single.srs,
        wire_plan=single._wire_plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prover.use_device_engine(engine)
    try:
        times, rounds, peaks = [], [], []
        with LaunchLog() as log:
            for i in range(3):                      # the first is warm
                if i == 1:
                    # the warm proof's shapes, before the timed proofs'
                    # counts and peaks (check drops the kept copies)
                    capture.check(rate, d=d, path=f"2^{k} proof")
                    first = len(log.entries)
                    kernels.reset_launches()
                    tracer.reset()
                t0 = time.perf_counter()
                with capture if i == 0 else contextlib.nullcontext():
                    proof, pis = prover.create_proof(
                        ChaCha12Rng.seed_from_u64(77), Bench(3))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                rounds.append(dict(engine.last_timings))
                peaks.append({r: v / 2 ** 30
                              for r, v in engine.last_peaks.items()})
                if proof.to_bytes() != ref[0].to_bytes() or pis != ref[1]:
                    raise AssertionError(f"sharded d={d}: proof {i} differs "
                                         f"from the single-device engine's")
            counts = kernels.launch_counts()
            classes = log.classes(start=first)
    finally:
        prover.use_device_engine(single)
    verifier.verify(proof, pis)
    rep = tracer.report()
    per_proof = {c: v / 2 for c, v in rep["counters"].items()}
    best = min((1, 2), key=lambda i: times[i])
    say("sharded", k=k, d=d, n_local=engine.n // d,
        nsd_local=engine.nsd // d, n8_local=engine.n8 // d,
        routes=_routes(engine), build_s=build_s, warm_s=times[0],
        proof_s=times[1:], best_s=times[best], rounds_best=rounds[best],
        rounds_warm=rounds[0], peak_gb_best=peaks[best],
        equal_to_single_device=True, verified=True,
        launches_a_proof={n: v / 2 for n, v in counts.items()},
        tracer_a_proof=per_proof,
        model_collective_bytes=proof_collective_bytes(k, d),
        gpu=nvidia_smi_line())
    say("sharded", k=k, d=d, launches_a_proof_by_shape={
        f"{name} {cls}": v / 2 for (name, cls), v in
        sorted(classes.items())})
    missing = [n for n in ("mont_mul", "ntt", "ec_add", "ec_scan_mixed",
                           "ec_sum_steps", "ec_scan_excl", "ec_double_add",
                           "ec_combine", "quotient") if counts[n] == 0]
    if missing:
        raise AssertionError(f"sharded d={d}: never launched on the "
                             f"sharded proof path: {missing}")
    if counts["quotient"] != 2 * d:
        raise AssertionError(f"sharded d={d}: quotient launched "
                             f"{counts['quotient'] / 2} times a proof")
    del engine
    torch.cuda.empty_cache()
    return {name: v // 2 for name, v in counts.items()}


def sharded_msm(pp, n, d, rate, capture):
    """ShardedMsm over d shards of cuda:0 on the first n SRS points and
    seeded scalars, under both tiers, each equal to the host C++ MSM; the
    warm calls under `capture`, whose kernels are held against their
    plain versions at each shape not yet held before the timed call."""
    import numpy as np
    import torch
    from dusk_plonk_torch import native
    from dusk_plonk_torch.fields.constants import R_MOD
    from dusk_plonk_torch.ops.limb import fr_field
    from dusk_plonk_torch.parallel import mesh as M
    from dusk_plonk_torch.parallel.msm import ShardedMsm
    mesh = M.Mesh(["cuda:0"] * d)
    rng = np.random.default_rng(8349)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD
               for _ in range(n)]
    points = tuple(M.shard(mesh, c[:, :n].contiguous()) for c in pp.packed)
    limbs = M.shard(mesh, fr_field().pack(scalars, "cuda",
                                          to_mont=False)[None])
    t0 = time.perf_counter()
    host = native.g1_msm(pp.powers[:n], scalars)
    host_s = time.perf_counter() - t0
    for tier in ("pippenger", "bit_serial"):
        smsm = ShardedMsm(mesh, mesh.axis, n, tier)
        prepared = smsm.prepare_points(points)
        with capture:
            smsm.msm_affine_batch(prepared, limbs)          # warm
        capture.check(rate, d=d, path=f"ShardedMsm {tier} n={n}")
        t0 = time.perf_counter()
        got = smsm.msm_affine_batch(prepared, limbs)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if got != host:
            raise AssertionError(f"sharded msm {tier}: differs from the "
                                 f"host C++ MSM")
        say("sharded", msm_tier=tier, n=n, d=d, s=wall, points_per_s=n / wall,
            equal_to_host=True, host_msm_s=host_s)


def phase_sharded(k, key):
    """The multi-device engine on a one-process mesh of cuda:0 (see the
    module docstring).  `key` is phase full's (pp, prover, verifier), or
    None to make it here.  Returns ({d: launches of a timed proof},
    {kernel: max error at the sharded shapes})."""
    import torch
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkKey, PlonkParams
    from dusk_plonk_torch.parallel.mesh import default_mesh
    rate = int_mul_rate()
    cards = default_mesh().devices
    if cards != tuple(torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())):
        raise AssertionError(f"default_mesh: {cards}")
    say("sharded", default_mesh=[str(c) for c in cards])
    capture = ShapeCapture()
    sharded_small("mixed", mixed_circuit(), (13, 5), 2, rate, capture)
    sharded_small("mixed", mixed_circuit(), (13, 5), 8, rate, capture)
    sharded_small("wide", wide_circuit(), (3,), 8, rate, capture)
    if key is None:
        pp = PlonkParams.setup_device(k, ChaCha12Rng.seed_from_u64(8349))
        key = (pp,) + PlonkKey.compile_device(pp, bench_circuit(k))
    pp, prover, _ = key
    ref = prover.create_proof(ChaCha12Rng.seed_from_u64(77),
                              bench_circuit(k)(3))
    torch.cuda.synchronize()
    counts = {d: sharded_bench(k, key, d, ref, rate, capture)
              for d in SHARDS}
    sharded_msm(pp, 1 << k, 4, rate, capture)
    say("sharded", shapes_held=len(capture.done),
        max_abs_err_by_kernel=capture.errs)
    return counts, capture.errs


PR = "dusk_plonk_tpu/ops/pallas_field.py"
SOURCES = {
    "mont_mul": ("dusk_plonk_torch/csrc/mont_mul.cu", f"{PR}:1314"),
    "ntt": ("dusk_plonk_torch/csrc/ntt.cu", f"{PR}:1409, {PR}:1458"),
    "ec_add": ("dusk_plonk_torch/csrc/ec_add.cu",
               f"{PR}:337 (K9), {PR}:1177 (K5 ec_add14, merged)"),
    "ec_add_mixed": ("dusk_plonk_torch/csrc/ec_add_mixed.cu",
                     f"{PR}:354 (K10)"),
    "ec_scan_mixed": ("dusk_plonk_torch/csrc/ec_scan.cu",
                      f"{PR}:769 (K11a), {PR}:926 (K3 ec_scan_mixed14, "
                      "merged)"),
    "ec_scan_mixed_em": ("dusk_plonk_torch/csrc/ec_scan_em.cu",
                         f"{PR}:990 (K12 ec_scan_mixed14_em)"),
    "ec_sum_steps": ("dusk_plonk_torch/csrc/ec_sum.cu",
                     f"{PR}:839 (K11b), {PR}:1049 (K6 ec_sum_steps14)"),
    "ec_scan_excl": ("dusk_plonk_torch/csrc/ec_scan_excl.cu",
                     f"{PR}:1145 (K4 ec_scan_excl14)"),
    "ec_double_add": ("dusk_plonk_torch/csrc/ec_double_add.cu",
                      f"{PR}:1223 (K7 ec_double_add14)"),
    "ec_combine": ("dusk_plonk_torch/csrc/ec_combine.cu",
                   f"{PR}:1277 (K8 ec_combine14)"),
    "reduce_planes": ("dusk_plonk_torch/csrc/reduce_planes.cu",
                      "dusk_plonk_tpu/ops/mxu_ntt.py:185 (K13)"),
    "quotient": ("dusk_plonk_torch/csrc/quotient.cu",
                 "dusk_plonk_tpu/proving/engine.py:465-524 (K14: the XLA "
                 "fusion of round3b; no pallas_call site)"),
}
# the path whose launches each row reports: the default proofs, except
# K8 (msm_device), K10 (the per-step scan route) and K12, K13 (the alt
# config's proofs)
PATH = {"ec_combine": ("msm",), "ec_add_mixed": ("alt", "step_scan"),
        "ec_scan_mixed_em": ("alt", "proof"),
        "reduce_planes": ("alt", "proof")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from dusk_plonk_torch.ops.msm import MsmPlan

    # main-path shapes of the 2^16 proof's MSM (per commit), and the JAX
    # MSM's per-step scan width at 2^10 points
    plan = MsmPlan((1 << K) + 7)
    nc = plan.n_pad // plan.chunk_len
    sa = 1 << ((plan.window_bits - 1) // 2)
    plan10 = MsmPlan(1 << 10)
    plan20 = MsmPlan((1 << K_LARGE) + 7)
    shapes = {"srs": plan.n, "scan": plan.num_windows * nc,
              "tails": plan.num_windows * (plan.nb + 1),
              "windows": plan.num_windows, "chunks": nc, "sa": sa,
              "sb": plan.nb // sa, "nb_log2": plan.nb.bit_length() - 1,
              "window_bits": plan.window_bits,
              "step_lanes": plan10.num_windows * (plan10.n_pad
                                                  // plan10.chunk_len),
              "k20": {"chunks": plan20.n_pad // plan20.chunk_len,
                      "group_rows": plan20.group_slots // plan20.n_pad}}

    results, counts = {}, {"msm": {}, "alt": {}}
    full_key, sharded_results = None, {}
    walls = {}
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        if name == "env":
            phase_env()
        elif name == "kernels":
            results.update(phase_kernels(shapes))
        elif name == "small":
            phase_small()
        elif name == "full":
            full_counts, full_key, results["quotient"] = phase_full(K)
            counts.update(full_counts)
        elif name == "msm":
            counts["msm"] = phase_msm()[0]
        elif name == "alt":
            counts["alt"] = phase_alt(K)
        elif name == "large":
            counts["large"], results["quotient_k20"] = phase_large(K_LARGE)
        elif name == "sharded":
            counts["sharded"], sharded_results = phase_sharded(K, full_key)
        walls[name] = time.perf_counter() - t0
        say("wall", of=name, s=walls[name])

    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = results.get(name, {})
        path = counts
        for key in PATH.get(name, ("proof",)):
            path = path.get(key, {})
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": path.get(name),
               "max_abs_err": r.get("max_abs_err"), "case": r.get("case"),
               "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
               "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
               "library_ms": None,
               "launches_k20_proof": counts.get("large", {}).get(
                   "proof", {}).get(name)}
        for d in SHARDS:
            row[f"launches_sharded_d{d}_proof"] = counts.get(
                "sharded", {}).get(d, {}).get(name)
        if name in sharded_results:
            row["max_abs_err_sharded_shapes"] = sharded_results[name]
        if name == "quotient" and "quotient_k20" in results:
            k20 = results["quotient_k20"]
            row["max_abs_err_k20"] = k20["max_abs_err"]
            row["case_k20"], row["ms_k20"] = k20["case"], k20["ms"]
        for key in ("max_abs_err_affine_vs_sequential",
                    "max_abs_err_vs_ladder"):
            if key in r:
                row[key] = r[key]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
