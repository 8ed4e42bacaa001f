"""Time block shapes of kernel K14 on one GPU: dusk_plonk_torch/csrc/
quotient.cu itself, built with -DQT=threads -DQMINB=blocks
(__launch_bounds__(QT, QMINB)), beside the package's own build (variant
`package`), each through its C entry point, median of 5 runs of 10
launches by CUDA events, on seeded random
canonical limbs in every input at E = 2^16 (a D = 8 shard of the 2^16
proof's coset), 2^19 (the 2^16 proof) and 2^23 (the 2^20 proof).  Every
variant must equal the package's kernel limb for limb; each prints its
ptxas registers and spills.

    cd tools/kernel_variants && python3 quotient_variants.py"""
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
from dusk_plonk_torch.fields.constants import R_MOD  # noqa: E402
from dusk_plonk_torch.ops import _build, kernels  # noqa: E402
from dusk_plonk_torch.ops.limb import fr_field  # noqa: E402

# name -> (QT, QMINB): the register cap is 65,536 / (QT QMINB)
VARIANTS = {"t128m1": (128, 1), "t256m1": (256, 1), "t128m3": (128, 3),
            "t128m4": (128, 4), "t256m2": (256, 2), "t64m8": (64, 8),
            "t512m1": (512, 1), "t128m5": (128, 5), "t128m6": (128, 6),
            "t256m3": (256, 3)}
P = ctypes.c_void_p
SOURCE = os.path.join(_build.CSRC_DIR, "quotient.cu")


def build():
    procs = []
    for name, (threads, minb) in VARIANTS.items():
        out = os.path.join(HERE, f"libq14_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
               f"-DQT={threads}", f"-DQMINB={minb}", "-o", out, SOURCE]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spill = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", log)
        fn = ctypes.CDLL(out).dt_quotient
        fn.argtypes = _build._SIGNATURES["dt_quotient"]
        fn.restype = ctypes.c_int
        fns[name] = fn, {"registers": regs, "spills": spill}
    fns["package"] = _build.lib().dt_quotient, {}
    return fns


def median_ms(launch, reps=10, runs=5):
    for _ in range(2):
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


def main():
    fns = build()
    F = fr_field()
    gen = torch.Generator("cuda").manual_seed(14)
    top = (R_MOD >> 240) >> 1

    def limbs(*shape):          # canonical Fr limbs: the top limb < r's / 2
        x = torch.randint(0, 1 << 16, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
        x[..., 15, :] &= top
        return x

    consts = limbs(16, len(kernels.QUOTIENT_TABLE)).contiguous()
    for log_e in (16, 19, 23):
        E = 1 << log_e
        evs = limbs(6, 16, E)
        args = (evs, evs[[0, 1, 2, 4], :, :8].contiguous(), limbs(11, 16, E),
                limbs(4, 16, E), limbs(16, E), limbs(16, E), limbs(16, E),
                consts)
        want = kernels.quotient(F, *args)
        for name, (fn, ptxas) in fns.items():
            out = torch.zeros_like(want)
            call = [P(t.data_ptr()) for t in args + (out,)] + \
                [E, consts.shape[-1], P(torch.cuda.current_stream()
                                         .cuda_stream)]

            def launch():
                assert fn(*call) == 0
            med, runs = median_ms(launch)
            print(json.dumps({"kernel": "K14", "E": E, "var": name,
                              "threads_minb": VARIANTS.get(name),
                              "equal": torch.equal(out, want), "ms": med,
                              "ms_runs": runs, **ptxas}), flush=True)
        del evs, args, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
