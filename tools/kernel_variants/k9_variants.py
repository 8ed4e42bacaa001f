"""Time variants of kernels K9 (k9_var.cu) and K8 (k8_var.cu) on one GPU
beside the package's own kernels (variant `package`), each through its C
entry point, median of 5 runs of 20 launches by CUDA events.

K9 at the MSM's bucket-tail widths, 81,940 and 327,760 lanes (one and four
2^16 commits), on random canonical limbs: every variant must equal the
package's K9 limb for limb.  K8 at msm_device's shape (W = 20 windows of
c = 13 bits) on 1 and 4 lanes of curve points with random Z: the team and
one-thread doubling variants equal the package's K8 limb for limb, the
serial complete-add order (the kernel before the team design) in affine
form.  Each variant's ptxas registers and spills are printed with it (the
package's are on chip_smoke.py's env line).

    cd tools/kernel_variants && python3 k9_variants.py"""
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

K9_VARIANTS = {"base": "", "minb3": "-DMINB=3", "minb4": "-DMINB=4",
               "pairs": "-DPAIRS", "team6": "-DTEAM=6", "team4": "-DTEAM=4",
               "team3": "-DTEAM=3", "lean": "-DLEAN",
               "lean3": "-DLEAN -DMINB=3", "lean4": "-DLEAN -DMINB=4"}
K8_VARIANTS = {"serial": "-DSERIAL", "dbl1": "-DDBL1", "shared": "-DSHARED"}
P = ctypes.c_void_p


def build():
    """{(kernel, variant): (C entry, ptxas registers / spills)}, every
    variant compiled at once, and the package's two entries."""
    procs = []
    for src, entry, variants in (("k9_var.cu", "dt_ec_add", K9_VARIANTS),
                                 ("k8_var.cu", "dt_ec_combine",
                                  K8_VARIANTS)):
        for name, flags in variants.items():
            out = os.path.join(HERE, f"lib{src[:2]}_{name}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                   "-Xptxas", "-v", "-o", out, os.path.join(HERE, src)] \
                + flags.split()
            procs.append((src[:2], name, entry, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    fns = {}
    for kern, name, entry, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{kern} {name}: nvcc failed\n{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spill = re.findall(r"(\d+) bytes spill stores", log)
        fn = getattr(ctypes.CDLL(out), entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[kern, name] = fn, {"registers": regs, "spill_stores": spill}
    fns["k9", "package"] = _build.lib().dt_ec_add, {}
    fns["k8", "package"] = _build.lib().dt_ec_combine, {}
    return fns


def median_ms(launch, reps=20, runs=5):
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


def main():
    fns = build()
    G1 = device_g1()
    F = G1.F
    gen = torch.Generator().manual_seed(3)

    def limbs(*shape):             # canonical Fq limbs: the top limb < q's
        x = torch.randint(0, 1 << 16, shape, generator=gen,
                          dtype=torch.int32)
        x[..., 23, :] &= 0x0fff
        return x.contiguous().to("cuda")

    for lanes in (81940, 327760):
        p = tuple(limbs(24, lanes) for _ in range(3))
        q = tuple(limbs(24, lanes) for _ in range(3))
        want = kernels.ec_add(G1, p, q)
        for (kern, name), (fn, ptxas) in fns.items():
            if kern != "k9":
                continue
            out = tuple(torch.zeros_like(c) for c in p)
            args = [P(c.data_ptr()) for c in p + q + out] + [1, lanes]

            def launch():
                assert fn(*args, stream()) == 0
            med, runs = median_ms(launch)
            print(json.dumps({"kernel": "K9", "lanes": lanes, "var": name,
                              "equal": all(torch.equal(x, y) for x, y in
                                           zip(out, want)),
                              "ms": med, "ms_runs": runs, **ptxas}),
                  flush=True)
        del p, q, want

    W, c = 20, 13
    pool = [bls.g1_mul(bls.G1_GENERATOR, 3 ** i + 7) for i in range(16)]
    for lanes in (1, 4):
        idx = torch.randint(0, 16, (W * lanes,), generator=gen).tolist()
        aff = G1.pack_points([pool[i] for i in idx], "cuda")
        z = limbs(24, W * lanes)
        g = tuple(F.mul(a, z).reshape(24, W, lanes).permute(1, 0, 2)
                  .contiguous() for a in aff[:2]) + \
            (z.reshape(24, W, lanes).permute(1, 0, 2).contiguous(),)
        want = kernels.ec_combine(G1, g, c)
        want_aff = G1.to_affine(want)
        for (kern, name), (fn, ptxas) in fns.items():
            if kern != "k8":
                continue
            out = tuple(torch.zeros_like(x) for x in want)
            args = [P(x.data_ptr()) for x in g + out] + [W, c, lanes]

            def launch():
                assert fn(*args, stream()) == 0
            med, runs = median_ms(launch, reps=5)
            print(json.dumps({"kernel": "K8", "lanes": lanes, "var": name,
                              "equal": all(torch.equal(x, y) for x, y in
                                           zip(out, want)),
                              "equal_affine": G1.to_affine(out) == want_aff,
                              "ms": med, "ms_runs": runs, **ptxas}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
