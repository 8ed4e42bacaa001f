"""Time K12's designs, the block design on K11a's layout, and K10's team
sizes on one GPU, each through a C entry point, median of 5 runs of 20
launches by CUDA events (K10: of 200 launches made by one C call).

K12 at an alt 2^16 proof's launches (cl = 256 on 5,140 / 10,280 / 20,560
lanes) and key compilation's (77,100), on affine points of G:
  serial        the one-thread scan before the team design, each thread
                storing its own rows (k12_var.cu);
  team2         the sequential order with each mixed add on two threads;
  teamN_staged  the package's team scan, N = 2, 3, 6 threads a mixed add,
                rows staged in shared memory and written contiguously;
  one_staged    the package's one-thread scan (staged rows);
  block T       the block-parallel scan at (T, ceil(256 / T)), T = 2, 4, 8,
                16, staged rows; `block T_unstaged` each thread storing its
                own rows; `k11a_block T` storing K11a's three limb planes,
                beside the package's K11a (`k11a`).
`rule` marks the package's choice (_scan_team).  `equal`: every
sequential-order variant equals serial limb for limb, and K11a its planes;
block T equals serial in affine form on the first 256 lanes, and its
unstaged and plane forms equal it limb for limb.  Each line carries the
dependent chain of adds.

K10 at 148 lanes (the JAX MSM's per-step route) and 81,940 (a launch that
fills the card) with T = 1 (the one-thread kernel before the team design),
2, 3 and 6 (the package's) threads a lane, each equal to T = 1 limb for
limb, and an empty kernel launched on the T = 6 grid of each width: the
launch floor.  Then the card's name and power limit.

    cd tools/kernel_variants && python3 k12_variants.py"""
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
from dusk_plonk_torch.curves import bls  # noqa: E402
from dusk_plonk_torch.ops import _build, kernels  # noqa: E402
from dusk_plonk_torch.ops.ec import device_g1  # noqa: E402

P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ENTRIES = {"k12_serial": [P, P, I, I64, P], "k12_team2": [P, P, I, I64, P],
           "k12_team_staged": [P, P, I, I64, I, P],
           "k12_block": [P] * 4 + [I, I64, I, I, I, P],
           "k10_loop": [P] * 8 + [I64, I64, I, I, P],
           "empty_loop": [I64, I, I, P]}
CL = 256
SCAN_LANES = (5140, 10280, 20560, 77100)
MIXED_LANES = (148, 81940)
AFFINE_LANES = 256            # lanes of a block scan held in affine form


def build():
    """The variant library and its entries, and ptxas's registers and
    spills by kernel."""
    out = os.path.join(HERE, "libk12_var.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
           "-o", out, os.path.join(HERE, "k12_var.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed\n{res.stderr[-3000:]}")
    ptxas, cur = {}, None
    for ln in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = ptxas.setdefault(m.group(1), {})
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and cur is not None:
            cur["spill_stores"] = int(m.group(1))
    lib = ctypes.CDLL(out)
    fns = {}
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def median_ms(launch, reps=20, runs=5):
    """(median, all): device ms a launch over `runs` runs of `reps` calls of
    launch(), by CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(runs):
        s.record()
        for _ in range(reps):
            launch()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e) / reps)
    return sorted(ms)[runs // 2], ms


def stream():
    return P(torch.cuda.current_stream().cuda_stream)


def ptr(t):
    return P(t.data_ptr())


def say(**fields):
    print(json.dumps(fields), flush=True)


def scan_variants(fns, G1, pool, gen):
    pkg = _build.lib()
    for lanes in SCAN_LANES:
        idx = torch.randint(0, pool[0].shape[-1], (CL * lanes,),
                            generator=gen).to("cuda")
        g = torch.cat([pool[0][:, idx], pool[1][:, idx]]).reshape(
            48, CL, lanes).permute(1, 0, 2).contiguous()
        del idx
        rule = kernels._scan_team(lanes)
        base = torch.empty((CL, lanes, 72), dtype=torch.int32, device="cuda")
        _build.check(fns["k12_serial"](ptr(g), ptr(base), CL, lanes,
                                       stream()), "serial")
        out = torch.empty_like(base)
        out2 = torch.empty_like(base)
        planes = tuple(torch.empty((CL, 24, lanes), dtype=torch.int32,
                                   device="cuda") for _ in range(3))

        def run(var, launch, equal, **extra):
            ms, runs = median_ms(launch)
            say(kernel="K12", lanes=lanes, var=var, equal=equal(), ms=ms,
                ms_runs=runs, **extra)

        def same_planes(ref):
            return all(torch.equal(c, ref[:, :, 24 * i:24 * (i + 1)]
                                   .transpose(1, 2))
                       for i, c in enumerate(planes))

        def affine(em):
            rows = em[:, :AFFINE_LANES]
            n = rows.shape[0] * rows.shape[1]
            return G1.affine(tuple(rows[:, :, 24 * i:24 * (i + 1)]
                                   .permute(2, 0, 1).reshape(24, n)
                                   for i in range(3)))

        run("serial", lambda: _build.check(fns["k12_serial"](
            ptr(g), ptr(base), CL, lanes, stream()), "serial"),
            lambda: True, chain_adds=CL)
        run("team2", lambda: _build.check(fns["k12_team2"](
            ptr(g), ptr(out), CL, lanes, stream()), "team2"),
            lambda: torch.equal(out, base), chain_adds=CL,
            chain_muls_a_step=6)
        for team in (2, 3, 6):
            run(f"team{team}_staged",
                lambda: _build.check(fns["k12_team_staged"](
                    ptr(g), ptr(out), CL, lanes, team, stream()), "team"),
                lambda: torch.equal(out, base), chain_adds=CL,
                chain_muls_a_step=-(-5 // team) + -(-6 // team),
                rule=team == rule)
        run("one_staged", lambda: _build.check(pkg.dt_ec_scan_mixed_em(
            ptr(g), ptr(out), CL, lanes, 1, stream()), "K12"),
            lambda: torch.equal(out, base), chain_adds=CL,
            chain_muls_a_step=11, rule=rule == 1)
        want = affine(base)
        for T in (2, 4, 8, 16):
            m = -(-CL // T)
            chain = 2 * m + T.bit_length() - 1
            run(f"block{T}",
                lambda: _build.check(fns["k12_block"](
                    ptr(g), ptr(out), P(0), P(0), CL, lanes, T, m, 2,
                    stream()), "block"),
                lambda: all(torch.equal(a, b)
                            for a, b in zip(affine(out), want)),
                block=(T, m), chain_adds=chain)
            run(f"block{T}_unstaged",
                lambda: _build.check(fns["k12_block"](
                    ptr(g), ptr(out2), P(0), P(0), CL, lanes, T, m, 1,
                    stream()), "block unstaged"),
                lambda: torch.equal(out2, out), block=(T, m),
                chain_adds=chain)
            run(f"k11a_block{T}",
                lambda: _build.check(fns["k12_block"](
                    ptr(g), *(ptr(c) for c in planes), CL, lanes, T, m, 0,
                    stream()), "block planes"),
                lambda: same_planes(out), block=(T, m), chain_adds=chain)
        run("k11a", lambda: _build.check(pkg.dt_ec_scan_mixed(
            ptr(g), *(ptr(c) for c in planes), CL, lanes, stream()), "K11a"),
            lambda: same_planes(base), chain_adds=CL)
        del g, base, out, out2, planes, want
        torch.cuda.empty_cache()


def mixed_variants(fns, G1, pool, gen):
    F = G1.F
    for lanes in MIXED_LANES:
        idx = torch.randint(0, pool[0].shape[-1], (2, lanes), generator=gen)
        z = torch.randint(0, 1 << 16, (24, lanes), generator=gen,
                          dtype=torch.int32)
        z[23] &= 0x0fff
        z = z.to("cuda")
        p = tuple(F.mul(c[:, idx[0].to("cuda")], z) for c in pool) + (z,)
        q2 = tuple(c[:, idx[1].to("cuda")].contiguous() for c in pool)
        outs = {}
        for T in (1, 2, 3, 6):
            out = tuple(torch.empty_like(z) for _ in range(3))
            args = [ptr(c) for c in p + q2 + out] + [1, lanes, T]

            def loop(reps):
                assert fns["k10_loop"](*args, reps, stream()) == 0
            ms, runs = median_ms(lambda: loop(200), reps=1)
            outs[T] = out
            chain = -(-5 // T) + -(-6 // T)
            say(kernel="K10", lanes=lanes, var="serial" if T == 1
                else f"team{T}", team=T, rule=T == 6,
                equal=all(torch.equal(a, b) for a, b in zip(out, outs[1])),
                ms=ms / 200, ms_runs=[t / 200 for t in runs],
                chain_muls=chain, us_per_chain_mul=ms / 200 * 1e3 / chain)
        blocks = -(-lanes // 5)
        ms, runs = median_ms(lambda: fns["empty_loop"](blocks, 32, 200,
                                                       stream()), reps=1)
        say(kernel="empty", lanes=lanes, blocks=blocks, threads=32,
            ms=ms / 200, ms_runs=[t / 200 for t in runs])


def main():
    fns, ptxas = build()
    say(ptxas=ptxas)
    G1 = device_g1()
    gen = torch.Generator().manual_seed(12)
    host = [bls.g1_mul(bls.G1_GENERATOR, 5 ** i + 3) for i in range(64)]
    pool = tuple(c.to("cuda") for c in G1.pack_points(host, "cpu")[:2])
    mixed_variants(fns, G1, pool, gen)
    scan_variants(fns, G1, pool, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
