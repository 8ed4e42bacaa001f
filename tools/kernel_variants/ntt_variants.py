"""Time variants of kernel K2's pass (ntt_var.cu: ntt.cu's pass with
switches) on one GPU, at three transforms of the proof path: (6, 16, 2^19)
coset_dft, (4, 16, 2^16) idft, (1, 16, 2^23) coset_dft.

    cd tools/kernel_variants && python3 ntt_variants.py "$(cat ntt_round3.json)"

A variant is {name: [source, nvcc flags, {k: [[log m per pass], [lines a
tile per pass]]}]}; without the third entry it takes the package's plan.
Switches of ntt_var.cu: NO_MEM (no HBM reads or writes of the data),
NO_COMPUTE (no butterflies), SKIP0 (no multiply at the first level),
RADIX4 (two levels a shared-memory round), NTT_T (threads a block).  Each
variant is built with nvcc into this directory, launched through its C
entry point, checked against the package's transform (`equal`; the NO_*
switches give wrong values by design) and timed per pass by CUDA events
(20 launches after 2)."""
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
from dusk_plonk_torch.ops import _build, kernels  # noqa: E402
from dusk_plonk_torch.ops.ntt import NttPlan  # noqa: E402

CASES = ((19, 6, "coset_dft"), (16, 4, "idft"), (23, 1, "coset_dft"))
P = ctypes.c_void_p


def build(variants):
    """{name: the variant's dt_ntt_pass}, built in parallel."""
    procs = []
    for name, (src, flags, *_) in variants.items():
        out = os.path.join(HERE, f"lib_{name}.so")
        cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
               "-Xptxas", "-v", "-o", out, os.path.join(HERE, src)] \
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
                     if "registers" in ln], flush=True)
        fn = ctypes.CDLL(out).dt_ntt_pass
        fn.argtypes = _build._SIGNATURES["dt_ntt_pass"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def make_passes(logs, lines):
    """kernels.ntt_passes' pass shapes for a given split and tile width."""
    out = []
    for i, lm in enumerate(logs):
        m, S, L = 1 << lm, 1 << sum(logs[i + 1:]), 1 << sum(logs[:i])
        if i < len(logs) - 1:
            out.append(kernels.NttPass(lm, lines[i], S, m * S, 1, S, m * S, 1,
                                       S, m * S))
        else:
            D = 1 << logs[0] if len(logs) > 1 else 1
            S1 = 1 << sum(logs[1:]) if len(logs) > 1 else 0
            out.append(kernels.NttPass(lm, lines[i], D, m, S1, 1, D, 1, L,
                                       0))
    return tuple(out)


def launches(plan, x, kind, outs):
    """The C-entry arguments of each pass of one transform."""
    steps = plan.steps_inv if "idft" in kind else plan.steps_fwd
    pre = plan.scale_coset if kind == "coset_dft" else None
    post = {"idft": plan.scale_n_inv,
            "coset_idft": plan.scale_coset_inv}.get(kind)
    src, out = x, []
    for i, (p, roots, mid) in enumerate(steps):
        if p.mid:
            pt, pm = mid, 3
        elif post is not None:
            pt, pm = post, 1 if post.shape[0] == 1 else 2
        else:
            pt, pm = None, 0
        pr = pre if i == 0 else None
        dst = outs[i % 2]
        out.append((P(src.data_ptr()), P(dst.data_ptr()), P(roots.data_ptr()),
                    P(0 if pr is None else pr.data_ptr()),
                    P(0 if pt is None else pt.data_ptr()), x.shape[0], plan.k,
                    p.log_m, p.lines, p.D, p.in_a, p.in_b, p.in_s, p.out_a,
                    p.out_b, p.out_s, int(pr is not None), pm,
                    P(torch.cuda.current_stream().cuda_stream)))
        src = dst
    return out, src


def time_launch(fn, args, reps=20):
    for _ in range(2):
        assert fn(*args) == 0
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        fn(*args)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main():
    variants = json.loads(sys.argv[1])
    fns = build(variants)
    gen = torch.Generator().manual_seed(1)
    orig = kernels.ntt_passes
    for k, batch, kind in CASES:
        x = torch.randint(0, 1 << 16, (batch, 16, 1 << k), generator=gen,
                          dtype=torch.int32)
        x[:, 15] &= 0x3fff                       # canonical: < r
        x = x.to("cuda")
        want = getattr(NttPlan(k, "cuda"), kind)(x)
        for name, fn in fns.items():
            spec = variants[name][2] if len(variants[name]) > 2 else {}
            if str(k) in spec:
                kernels.ntt_passes = \
                    lambda kk, passes=None, s=spec[str(k)]: make_passes(*s)
            try:
                plan = NttPlan(k, "cuda")
            finally:
                kernels.ntt_passes = orig
            args, res = launches(plan, x, kind,
                                 (torch.zeros_like(x), torch.zeros_like(x)))
            for a in args:
                assert fn(*a) == 0
            torch.cuda.synchronize()
            ms = [time_launch(fn, a) for a in args]
            print(json.dumps({
                "case": f"{kind}(B={batch},k={k})", "var": name,
                "equal": torch.equal(res, want),
                "plan": [(p.log_m, p.lines) for p in plan.passes],
                "pass_ms": [round(v, 4) for v in ms],
                "total": round(sum(ms), 4)}), flush=True)
        del x, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout)


if __name__ == "__main__":
    main()
