#!/usr/bin/env python3
"""Smoke test of the torch port (dusk_plonk_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases env,kernels,small,full,msm]

Phases, one summary line each (more for kernels):
  1. env: the card, torch / CUDA / nvcc versions, and the build of the
     CUDA kernels from dusk_plonk_torch/csrc (nvcc, sm_90a, one process per
     source);
  2. kernels: every kernel against its plain PyTorch version, limb for
     limb, at the shapes the 2^16 proof, key compilation and MSM give it,
     with both times;
  3. small: at k = 7, device SRS setup equal to the host setup, device key
     compilation equal to the host compilation (verification key bytes),
     and a proof equal to the host oracle's field for field, verified;
  4. full: bench.py's proof path at 2^16 constraints: PlonkParams.
     setup_device, PlonkKey.compile_device (per-step times, 16 SRS powers
     spot-checked against the host), one warm and two timed proofs, the
     host verifier, and each kernel's launches on each path (> 0);
  5. msm: bench.py's MSM metric, MsmPlan.msm_device on 2^16 seeded
     points, equal to the host C++ MSM, best of 3 in points/s.

Then a JSON line of per-kernel results (with each kernel's bound), the
card's name and power limit, and, last, {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; without CUDA it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "small", "full", "msm")
K = 16          # log2 constraints of the full-width proof (bench.py's 2^16)


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
    with open(_build.BUILD_LOG) as f:
        regs = [ln.strip() for ln in f if "registers" in ln
                or "spill" in ln or "Compiling entry" in ln]
    say("env", gpu=nvidia_smi_line(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        nvcc=nvcc.strip().splitlines()[-1], build_s=build_s,
        int_muls_per_s=int_mul_rate(), hbm_bytes_per_s=HBM_BYTES_PER_S,
        ptxas=" | ".join(regs))


def phase_kernels(shapes):
    """Each kernel vs its plain version on the same inputs; the first case
    of each kernel is its headline shape, whose bound the JSON line
    carries."""
    import torch
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.ops.limb import fr_field, fq_field
    from dusk_plonk_torch.ops.ntt import NttPlan
    from dusk_plonk_torch.ops.ec import device_g1
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkParams
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8349)
    Fr, Fq, G1 = fr_field(), fq_field(), device_g1()
    rate = int_mul_rate()
    results = {}

    def record(name, key, out, ref, ms, plain_ms, work):
        err = max_abs_err(out, ref)
        bound_ms, bound_by = bound(*work, rate)
        say("kernels", kernel=name, case=key, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
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

    # K1: Fr at the 8n quotient width, Fq at the SRS packing width and at
    # the JAX MSM's padded lane width
    for F, shape in ((Fr, (1 << 19,)), (Fq, (shapes["srs"],)), (Fq, (5760,))):
        a = rand_limbs(gen, F, shape, dev)
        b = rand_limbs(gen, F, shape, dev)
        n = shape[-1]
        check("mont_mul", f"{F.spec.name}(L={F.L},N={n})",
              lambda: F.mul(a, b), lambda: F.mul_plain(a, b), 20,
              (3 * F.L * n * 4, n * (FR_MUL if F.L == 16 else FQ_MUL)))

    # K2: the proof's transforms (round-3 coset pair at 8n, round-1 wire
    # iNTTs at n), then dft / coset_dft at the widths of the JAX engine's
    # batches, and key compilation's 11 + 4 selector and sigma iNTTs; kernel
    # path vs the plain ladder, times are the k stages alone
    plans = {k: NttPlan(k, dev) for k in (16, 19)}
    for k, batch, kind in ((19, 6, "coset_dft"), (19, 1, "coset_idft"),
                           (16, 4, "idft"), (16, 4, "dft"),
                           (16, 4, "coset_dft"), (19, 2, "dft"),
                           (19, 2, "coset_dft"), (16, 11, "idft")):
        plan = plans[k]
        n = 1 << k
        tw, pre, post = {
            "dft": (plan.tw_fwd, plan.scale_one, plan.scale_one),
            "coset_dft": (plan.tw_fwd, plan.scale_coset, plan.scale_one),
            "coset_idft": (plan.tw_inv, plan.scale_one,
                           plan.scale_coset_inv),
            "idft": (plan.tw_inv, plan.scale_one, plan.scale_n_inv)}[kind]
        x = rand_limbs(gen, Fr, (batch, n), dev)
        out = getattr(plan, kind)(x)
        br = Fr.mul_plain(x, pre).index_select(-1, plan.bitrev)
        ref, plain_ms = cuda_once(
            lambda: kernels.ntt_ladder_plain(Fr, br, tw, k))
        record("ntt_stage", f"{kind}(B={batch},k={k})", out,
               Fr.mul_plain(ref, post),
               cuda_ms(lambda: kernels.ntt_ladder(Fr, br, tw, k), 5),
               plain_ms,
               ((2 * batch + 1 / 2) * 16 * n * 4,
                batch * k * (n // 2) * FR_MUL))

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

    # K9: the bucket-tail read width; identity, P + P and P + (-P) lanes
    lanes = shapes["tails"]
    p, q = proj(lanes), proj(lanes)
    q = tuple(c.clone() for c in q)
    ident = G1.identity(dev)
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
        raise AssertionError("ec_add: group law violated on special lanes")
    check("ec_add", f"lanes={lanes}", lambda: kernels.ec_add(G1, p, q),
          lambda: kernels.ec_add_plain(G1, p, q), 20,
          (9 * 24 * lanes * 4, lanes * EC_ADD))

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

    # K11b: level 1 (sb steps on W * sa lanes a commit) and level 2 (sa
    # steps on W lanes) of the bucket sum, for the proof's 4-commit batch
    # and key compilation's 15-commit batch
    W, sa, sb = shapes["windows"], shapes["sa"], shapes["sb"]
    for steps, lanes in ((sb, 4 * W * sa), (sa, 4 * W), (sb, 15 * W * sa)):
        g = proj_steps(steps, lanes)
        check("ec_sum_steps", f"(steps={steps},lanes={lanes})",
              lambda: kernels.ec_sum_steps(G1, g),
              lambda: kernels.ec_sum_steps_plain(G1, g), 5,
              ((steps + 1) * 72 * lanes * 4, steps * lanes * EC_ADD))

    # K4: the chunk offsets, nc steps on one lane per (commit, window)
    nc = shapes["chunks"]
    for lanes in (4 * W, 15 * W):
        g = proj_steps(nc, lanes)
        check("ec_scan_excl", f"(steps={nc},lanes={lanes})",
              lambda: kernels.ec_scan_excl(G1, g),
              lambda: kernels.ec_scan_excl_plain(G1, g), 3,
              (2 * nc * 72 * lanes * 4, (nc - 1) * lanes * EC_ADD))

    # K7: NB * full_sum - sum, 2^(c-1) = 2^k doublings
    kd = shapes["nb_log2"]
    for lanes in (4 * W, 15 * W):
        a, b = proj(lanes), tuple(c.clone() for c in proj(lanes))
        for c, i in zip(b, G1.identity(dev)):
            c[:, 0:1] = i
        check("ec_double_add", f"(k={kd},lanes={lanes})",
              lambda: kernels.ec_double_add(G1, a, b, kd),
              lambda: kernels.ec_double_add_plain(G1, a, b, kd), 5,
              (3 * 72 * lanes * 4, (kd + 1) * lanes * EC_ADD))

    # K8: the window combine of msm_device, W windows of c bits, one lane
    # per MSM
    c = shapes["window_bits"]
    g = proj_steps(W, 1)
    check("ec_combine", f"(W={W},c={c},lanes=1)",
          lambda: kernels.ec_combine(G1, g, c),
          lambda: kernels.ec_combine_plain(G1, g, c), 5,
          ((W + 1) * 72 * 4, W * (c + 1) * EC_ADD))
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


def phase_full(k):
    """bench.py's proof path: device setup, device key compilation, one
    warm and two timed proofs.  Each path's kernel launches are counted
    from 0 just before it."""
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
        commit15_peak_gb=engine.commit15_peak_bytes / 2 ** 30,
        ns=engine.ns, n8=engine.n8, launches_setup=counts["setup"],
        launches_compile=counts["compile"])

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    proof, pis = prover.create_proof(rng, Bench(3))            # warm
    warm = dict(engine.last_timings)
    verifier.verify(proof, pis)
    times, rounds = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        proof, pis = prover.create_proof(rng, Bench(3))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rounds.append(dict(engine.last_timings))
    counts["proof"] = kernels.launch_counts()
    t0 = time.perf_counter()
    verifier.verify(proof, pis)
    verify_s = time.perf_counter() - t0
    best = min(range(2), key=lambda i: times[i])
    say("full", k=k, proof_s=times, best_s=times[best],
        rounds_best=rounds[best], rounds_warm=warm, verified=True,
        verify_s=verify_s, launches_proof=counts["proof"],
        ec_add_per_proof=counts["proof"]["ec_add"] / 3,
        ec_add_per_proof_pr1=604,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    need = {"setup": ("ec_add",),
            "compile": ("mont_mul", "ntt_ladder", "ec_add", "ec_scan_mixed",
                        "ec_sum_steps", "ec_scan_excl", "ec_double_add"),
            "proof": ("mont_mul", "ntt_ladder", "ec_add", "ec_scan_mixed",
                      "ec_sum_steps", "ec_scan_excl", "ec_double_add")}
    missing = [(path, name) for path, names in need.items()
               for name in names if counts[path][name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    return counts


def phase_msm():
    """bench.py's MSM metric: msm_device on 2^16 seeded points (tau^i G of
    a seeded device setup) and seeded scalars, best of 3, equal to the
    host C++ MSM."""
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
        raise AssertionError("msm_device differs from the host MSM")
    best = min(times)
    say("msm", n=n, times_s=times, best_s=best, points_per_s=n / best,
        equal_to_host=True, launches=counts)
    if counts["ec_combine"] == 0:
        raise AssertionError("ec_combine never launched by msm_device")
    return counts


PR = "dusk_plonk_tpu/ops/pallas_field.py"
SOURCES = {
    "mont_mul": ("dusk_plonk_torch/csrc/mont_mul.cu", f"{PR}:1314"),
    "ntt_stage": ("dusk_plonk_torch/csrc/ntt.cu", f"{PR}:1409, {PR}:1458"),
    "ec_add": ("dusk_plonk_torch/csrc/ec_add.cu",
               f"{PR}:337 (K9), {PR}:1177 (K5 ec_add14, merged)"),
    "ec_scan_mixed": ("dusk_plonk_torch/csrc/ec_scan.cu",
                      f"{PR}:769 (K11a), {PR}:926 (K3 ec_scan_mixed14, "
                      "merged)"),
    "ec_sum_steps": ("dusk_plonk_torch/csrc/ec_sum.cu",
                     f"{PR}:839 (K11b), {PR}:1049 (K6 ec_sum_steps14)"),
    "ec_scan_excl": ("dusk_plonk_torch/csrc/ec_scan_excl.cu",
                     f"{PR}:1145 (K4 ec_scan_excl14)"),
    "ec_double_add": ("dusk_plonk_torch/csrc/ec_double_add.cu",
                      f"{PR}:1223 (K7 ec_double_add14)"),
    "ec_combine": ("dusk_plonk_torch/csrc/ec_combine.cu",
                   f"{PR}:1277 (K8 ec_combine14)"),
}
WRAPPER = {name: name for name in SOURCES}
WRAPPER["ntt_stage"] = "ntt_ladder"


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

    # main-path shapes of the 2^16 proof's MSM (per commit)
    plan = MsmPlan((1 << K) + 7)
    nc = plan.n_pad // plan.chunk_len
    sa = 1 << ((plan.window_bits - 1) // 2)
    shapes = {"srs": plan.n, "scan": plan.num_windows * nc,
              "tails": plan.num_windows * (plan.nb + 1),
              "windows": plan.num_windows, "chunks": nc, "sa": sa,
              "sb": plan.nb // sa, "nb_log2": plan.nb.bit_length() - 1,
              "window_bits": plan.window_bits}

    if "env" in phases:
        phase_env()
    results = phase_kernels(shapes) if "kernels" in phases else {}
    if "small" in phases:
        phase_small()
    counts = phase_full(K) if "full" in phases else {}
    msm_counts = phase_msm() if "msm" in phases else {}

    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = results.get(name, {})
        # launches on the main path: the three proofs; msm_device for K8
        path = msm_counts if name == "ec_combine" else counts.get("proof",
                                                                  {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": path.get(WRAPPER[name]),
                     "max_abs_err": r.get("max_abs_err"),
                     "case": r.get("case"), "ms": r.get("ms"),
                     "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"), "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
