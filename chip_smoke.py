#!/usr/bin/env python3
"""Smoke test of the torch port (dusk_plonk_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one summary line each:
  1. environment: the card, torch / CUDA / nvcc versions, and the build of
     the CUDA kernels from dusk_plonk_torch/csrc (nvcc, sm_90a);
  2. every kernel against its plain PyTorch version, limb for limb, at the
     shapes the 2^16 proof gives it, with both times;
  3. a small proof (k = 7, four gate families) through the port, equal to
     the host oracle's proof field for field, and verified;
  4. the 2^16-constraint bench circuit: host setup and key compilation,
     one warm proof and two timed proofs through the port, the host
     verifier, and every kernel's launch count from that run (> 0).

Then a JSON line of per-kernel results, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "small", "full")
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
    from dusk_plonk_torch.ops import _build, msm
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    msm.require_host_combine()
    with open(_build.BUILD_LOG) as f:
        regs = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    say("env", gpu=nvidia_smi_line(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        nvcc=nvcc.strip().splitlines()[-1], build_s=build_s,
        ptxas=" | ".join(regs))


def phase_kernels(shapes):
    """Each kernel vs its plain version on the same inputs."""
    import torch
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.ops.limb import fr_field, fq_field
    from dusk_plonk_torch.ops.ntt import NttPlan
    from dusk_plonk_torch.ops.ec import device_g1
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkParams
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8349)
    Fr, Fq, G1 = fr_field(), fq_field(), device_g1()
    results = {}

    def record(name, key, out, ref, ms, plain_ms, **extra):
        err = max_abs_err(out, ref)
        say("kernels", kernel=name, case=key, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, **extra)
        if err != 0:
            raise AssertionError(f"{name} {key}: kernel != plain ({err})")
        # the first case of each kernel is its headline shape
        r = results.setdefault(name, {"max_abs_err": 0, "case": key,
                                      "ms": ms, "plain_ms": plain_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # K1: Fr at the 8n quotient width, Fq at the SRS packing width and at
    # the JAX MSM's padded lane width
    for F, shape in ((Fr, (1 << 19,)), (Fq, (shapes["srs"],)), (Fq, (5760,))):
        a = rand_limbs(gen, F, shape, dev)
        b = rand_limbs(gen, F, shape, dev)
        out = F.mul(a, b)
        ref = F.mul_plain(a, b)
        record("mont_mul", f"{F.spec.name}(L={F.L},N={shape[-1]})", out, ref,
               cuda_ms(lambda: F.mul(a, b), 20),
               cuda_ms(lambda: F.mul_plain(a, b), 3))

    # K2: the proof's transforms (round-3 coset pair at 8n, round-1 wire
    # iNTTs at n), then dft / coset_dft at the widths of the JAX engine's
    # batches; kernel path vs the plain ladder, times are the k stages alone
    plans = {k: NttPlan(k, dev) for k in (16, 19)}
    for k, batch, kind in ((19, 6, "coset_dft"), (19, 1, "coset_idft"),
                           (16, 4, "idft"), (16, 4, "dft"),
                           (16, 4, "coset_dft"), (19, 2, "dft"),
                           (19, 2, "coset_dft")):
        plan = plans[k]
        tw, pre, post = {
            "dft": (plan.tw_fwd, plan.scale_one, plan.scale_one),
            "coset_dft": (plan.tw_fwd, plan.scale_coset, plan.scale_one),
            "coset_idft": (plan.tw_inv, plan.scale_one,
                           plan.scale_coset_inv),
            "idft": (plan.tw_inv, plan.scale_one, plan.scale_n_inv)}[kind]
        x = rand_limbs(gen, Fr, (batch, 1 << k), dev)
        out = getattr(plan, kind)(x)
        br = Fr.mul_plain(x, pre).index_select(-1, plan.bitrev)
        ref = Fr.mul_plain(kernels.ntt_ladder_plain(Fr, br, tw, k), post)
        record("ntt_stage", f"{kind}(B={batch},k={k})", out, ref,
               cuda_ms(lambda: kernels.ntt_ladder(Fr, br, tw, k), 5),
               cuda_ms(lambda: kernels.ntt_ladder_plain(Fr, br, tw, k), 1))

    # points: 64 SRS powers of a seeded setup, random projective
    # representatives of them
    host = PlonkParams.setup(6, ChaCha12Rng.seed_from_u64(8349)).powers[:64]
    aff = G1.pack_points(host, dev)                    # (24, 64) z = 1

    def proj(lanes):
        idx = torch.randint(0, 64, (lanes,), generator=gen).to(dev)
        zr = rand_limbs(gen, Fq, (lanes,), dev)
        x, y = aff[0][:, idx], aff[1][:, idx]
        return (Fq.mul(x, zr), Fq.mul(y, zr), zr.clone())

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
    ref = kernels.ec_add_plain(G1, p, q)
    # group law on the special lanes: P + O = P, O + Q = Q, O + O = O,
    # P + (-P) = O
    got = G1.to_affine(tuple(c[:, :13] for c in out))
    hp = G1.to_affine(tuple(c[:, :13] for c in p))
    hq = G1.to_affine(tuple(c[:, :13] for c in q))
    if (got[0] != hp[0] or got[1] != hq[1] or got[2] is not None
            or any(got[i] is not None for i in range(8, 13))):
        raise AssertionError("ec_add: group law violated on special lanes")
    record("ec_add", f"lanes={lanes}", out, ref,
           cuda_ms(lambda: kernels.ec_add(G1, p, q), 20),
           cuda_ms(lambda: kernels.ec_add_plain(G1, p, q), 3))

    # K11a: the chunk scan of one 2^16 commit, then at the JAX MSM's
    # padded lane width
    cl = 256
    for lanes in (shapes["scan"], 5760):
        idx = torch.randint(0, 64, (cl * lanes,), generator=gen).to(dev)
        g = torch.cat([aff[0][:, idx], aff[1][:, idx]]).reshape(
            48, cl, lanes).permute(1, 0, 2).contiguous()
        out = G1.scan_mixed(g)
        ref = kernels.ec_scan_mixed_plain(G1, g)
        record("ec_scan_mixed", f"(cl={cl},48,lanes={lanes})", out, ref,
               cuda_ms(lambda: kernels.ec_scan_mixed(G1, g), 3),
               cuda_ms(lambda: kernels.ec_scan_mixed_plain(G1, g), 1))
    return results


def phase_small():
    import torch
    from dusk_plonk_torch.prelude import (
        ChaCha12Rng, PlonkKey, PlonkParams, compile_circuit_torch)
    Mixed = mixed_circuit()
    rng_h = ChaCha12Rng.seed_from_u64(8349)
    prover_h, verifier = PlonkKey.compile(PlonkParams.setup(7, rng_h), Mixed)
    rng_d = ChaCha12Rng.seed_from_u64(8349)
    prover_d, _ = compile_circuit_torch(PlonkParams.setup(7, rng_d), Mixed(),
                                        "cuda")
    proof_h, pis_h = prover_h.create_proof(rng_h, Mixed(13, 5))
    proof_d, pis_d = prover_d.create_proof(rng_d, Mixed(13, 5))
    torch.cuda.synchronize()
    for f in PROOF_FIELDS:
        if getattr(proof_h, f) != getattr(proof_d, f):
            raise AssertionError(f"k=7 proof differs from host at {f}")
    if pis_h != pis_d:
        raise AssertionError("public inputs differ")
    verifier.verify(proof_d, pis_d)
    say("small", k=7, equal_to_host=True, verified=True,
        timings=prover_d.engine.last_timings)


def phase_full(k):
    import torch
    from dusk_plonk_torch.ops import kernels
    from dusk_plonk_torch.prelude import (
        ChaCha12Rng, PlonkParams, compile_circuit_torch)
    Bench = bench_circuit(k)
    rng = ChaCha12Rng.seed_from_u64(8349)
    t0 = time.perf_counter()
    pp = PlonkParams.setup(k, rng)
    t1 = time.perf_counter()
    prover, verifier = compile_circuit_torch(pp, Bench(), "cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say("full", k=k, setup_s=t1 - t0, compile_s=t2 - t1,
        ns=prover.engine.ns, n8=prover.engine.n8)
    # the launch counts cover the three proofs and nothing else
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    proof, pis = prover.create_proof(rng, Bench(3))            # warm
    warm = dict(prover.engine.last_timings)
    times, rounds = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        proof, pis = prover.create_proof(rng, Bench(3))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rounds.append(dict(prover.engine.last_timings))
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    verifier.verify(proof, pis)
    verify_s = time.perf_counter() - t0
    best = min(range(2), key=lambda i: times[i])
    say("full", k=k, proof_s=times, best_s=times[best],
        rounds_best=rounds[best], rounds_warm=warm, verified=True,
        verify_s=verify_s, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    return launches


SOURCES = {
    "mont_mul": ("dusk_plonk_torch/csrc/mont_mul.cu",
                 "dusk_plonk_tpu/ops/pallas_field.py:1314"),
    "ntt_stage": ("dusk_plonk_torch/csrc/ntt.cu",
                  "dusk_plonk_tpu/ops/pallas_field.py:1409"),
    "ec_add": ("dusk_plonk_torch/csrc/ec_add.cu",
               "dusk_plonk_tpu/ops/pallas_field.py:337"),
    "ec_scan_mixed": ("dusk_plonk_torch/csrc/ec_scan.cu",
                      "dusk_plonk_tpu/ops/pallas_field.py:769"),
}
WRAPPER = {"mont_mul": "mont_mul", "ntt_stage": "ntt_ladder",
           "ec_add": "ec_add", "ec_scan_mixed": "ec_scan_mixed"}


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

    # main-path shapes of the 2^16 proof's MSM (one commit)
    plan = MsmPlan((1 << K) + 7)
    nc = plan.n_pad // plan.chunk_len
    shapes = {"srs": plan.n, "scan": plan.num_windows * nc,
              "tails": plan.num_windows * (plan.nb + 1)}

    if "env" in phases:
        phase_env()
    results = phase_kernels(shapes) if "kernels" in phases else {}
    if "small" in phases:
        phase_small()
    launches = phase_full(K) if "full" in phases else {}

    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = results.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": launches.get(WRAPPER[name]),
                     "max_abs_err": r.get("max_abs_err"),
                     "case": r.get("case"), "ms": r.get("ms"),
                     "plain_ms": r.get("plain_ms")})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
