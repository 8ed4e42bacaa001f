"""Time variants of kernel K7 (k7_var.cu: ec_double_add.cu with the
doubling's independent multiplies interleaved under INTERLEAVE) on one
GPU at the MSM's shapes, k = 12 on 80 and 300 lanes, against the
package's K7 (`equal`), median of 5 x 50 launches by CUDA events.

    cd tools/kernel_variants && python3 k7_variants.py"""
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
from dusk_plonk_torch.ops import _build, kernels  # noqa: E402
from dusk_plonk_torch.ops.ec import device_g1  # noqa: E402

VARIANTS = {"base": "-DTHREADS=128", "il": "-DTHREADS=128 -DINTERLEAVE",
            "il32": "-DTHREADS=32 -DINTERLEAVE", "base32": "-DTHREADS=32"}
P = ctypes.c_void_p


def build():
    procs = []
    for name, flags in VARIANTS.items():
        out = os.path.join(HERE, f"libk7_{name}.so")
        cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
               "-Xptxas", "-v", "-o", out, os.path.join(HERE, "k7_var.cu")] \
            + flags.split()
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        print(name, [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln], flush=True)
        fn = ctypes.CDLL(out).dt_ec_double_add
        fn.argtypes = _build._SIGNATURES["dt_ec_double_add"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    fns = build()
    G1 = device_g1()
    gen = torch.Generator().manual_seed(3)

    def points(lanes):            # canonical Fq limbs: the top limb < q's
        x = torch.randint(0, 1 << 16, (3, 24, lanes), generator=gen,
                          dtype=torch.int32)
        x[:, 23] &= 0x0fff
        return tuple(c.contiguous().to("cuda") for c in x)

    for lanes in (80, 300):
        a, b = points(lanes), points(lanes)
        want = kernels.ec_double_add(G1, a, b, 12)
        for name, fn in fns.items():
            out = tuple(torch.zeros_like(c) for c in a)
            args = [P(c.data_ptr()) for c in a + b + out] + [
                12, lanes, P(torch.cuda.current_stream().cuda_stream)]
            for _ in range(3):
                assert fn(*args) == 0
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            ms = []
            for _ in range(5):
                s.record()
                for _ in range(50):
                    fn(*args)
                e.record()
                torch.cuda.synchronize()
                ms.append(s.elapsed_time(e) / 50)
            print(json.dumps({"lanes": lanes, "var": name, "equal": all(
                torch.equal(x, y) for x, y in zip(out, want)),
                "ms": sorted(ms)[2]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout)


if __name__ == "__main__":
    main()
