"""Time shapes of kernel K14 on one GPU, each beside the others in one
call: the earlier one-thread design (quotient_var.cu, blocks of 256
held to two an SM) and the package's family-group design,
dusk_plonk_torch/csrc/quotient.cu itself built with -DQMINB=m (blocks
of 32 g threads on 32 points, at least m resident an SM; g = 3 by the
probe g3), alone or with probes (text substitutions in a copy of csrc:
PROBES),
and the package's own build (variant `package`, g4m5).  Each is launched
through its C entry point on seeded random canonical limbs in every
input, the halo the grid's own first 8 columns, the constant table from
seeded random challenges (kernels.quotient_consts), at E = 2^16 (a D = 8
shard of the 2^16 proof's coset), 2^17 (D = 4), 2^19 (the 2^16 proof) and
2^23 (the 2^20 proof): median of 5 runs of 10 launches by CUDA events.
Every variant must equal the package's kernel limb for limb at every E
(but the `l1` probe, which reads other points), and the package's kernel
its plain version (K1's plain multiply) at E = 32, a ragged 1,000 and
2^16; each variant prints its ptxas registers, spills and stack, and its
SASS opcode counts (cuobjdump).  `--peak` also times the Fr multiply
alone (fr_mul_peak.cu: independent chains of 2,000 multiplies, 1, 2 or 4
a thread, blocks of 128 at every occupancy the register count allows and
at 16 and 8 warps an SM), the rate K14's multiplies are read against;
`--rounds 2` times the variants in order, then in reverse order.

    cd tools/kernel_variants && python3 quotient_variants.py [--peak]
        [--rounds 2] [--variants NAME,NAME]"""
import argparse
import ctypes
import json
import os
import random
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
from dusk_plonk_torch.fields.constants import R_MOD  # noqa: E402
from dusk_plonk_torch.ops import _build, kernels  # noqa: E402
from dusk_plonk_torch.ops.limb import fr_field  # noqa: E402

# probes, each a list of (file, old, new) substituted once in a copy of
# csrc.  g3: three groups of gate families (30, 27, 27 multiplies + 2 to
# combine) in place of the package's four; h0: plain loads, no L1 hint; h1: the evs rows without
# evict_last; mont: field.cuh's mont_mul<8> in place of Fr's shaped
# multiply; mulk: the small constants (9, 18, 81, the permutation's 7,
# 13, 17) multiply from the table instead of by adds; pf1, pf2: the block
# first asks for its input lines (one 128-byte line a limb row of each of
# the 24 planes) into L1 or L2; l1: every plane load reads point i & 31
# of its row, so the inputs stay in L1 (timed, not held)
KEEP = "ld.global.nc.L1::evict_last.u32"
PASS = "ld.global.nc.L1::no_allocate.u32"
PREFETCH_FN = """\
// the block's input lines, one 128-byte line a limb row of each of the
// 24 planes (32 points), into L1 or L2
__device__ __forceinline__ void prefetch_tiles(const QuotientIn& q,
                                               int64_t first) {
  constexpr int LINES = 24 * 16;
  for (int r = threadIdx.x; r < LINES; r += QT) {
    int plane = r >> 4, limb = r & 15;
    const uint32_t* base =
        plane < 6 ? q.evs + (int64_t)plane * 16 * q.E
        : plane < 17 ? q.sel + (int64_t)(plane - 6) * 16 * q.E
        : plane < 21 ? q.sig + (int64_t)(plane - 17) * 16 * q.E
        : plane == 21 ? q.l1 : plane == 22 ? q.lin : q.vh_inv;
    const uint32_t* a = base + (int64_t)limb * q.E + first;
    asm volatile("prefetch.global.LEVEL [%0];" ::"l"(a));
  }
}

"""


def prefetch(level):
    return [("quotient.cu", "__global__ void __launch_bounds__(QT, QMINB)",
             PREFETCH_FN.replace("LEVEL", level)
             + "__global__ void __launch_bounds__(QT, QMINB)"),
            ("quotient.cu", "  __syncthreads();\n  const int lane",
             "  prefetch_tiles(q, (int64_t)blockIdx.x * 32);\n"
             "  __syncthreads();\n  const int lane")]


FOUR_GROUPS = """\
  if (g == 0) {
    logic(fam, q, i, cst);
    perm_identity(perm, q, i, cst);
  } else if (g == 1) {
    range(fam, q, i, cst);
    arithmetic(fam, q, i);
    perm_l1(perm, q, i, cst);
  } else if (g == 2) {
    variable_base(fam, q, i, cst);
    perm_sigma(perm, q, i, cst);
  } else {
    fixed_base(fam, q, i, cst);
  }
"""
THREE_GROUPS = """\
  if (g == 0) {
    range(fam, q, i, cst);
    variable_base(fam, q, i, cst);
    perm_identity(perm, q, i, cst);
  } else if (g == 1) {
    logic(fam, q, i, cst);
    arithmetic(fam, q, i);
    perm_l1(perm, q, i, cst);
  } else {
    fixed_base(fam, q, i, cst);
    perm_sigma(perm, q, i, cst);
  }
"""


PROBES = {
    "g3": [("quotient.cuh", "#define Q14_GROUPS 4", "#define Q14_GROUPS 3"),
           ("quotient.cuh", FOUR_GROUPS, THREE_GROUPS)],
    "h0": [("quotient.cuh", KEEP, "ld.global.u32"),
           ("quotient.cuh", PASS, "ld.global.u32")],
    "h1": [("quotient.cuh", KEEP, "ld.global.nc.u32")],
    "mont": [("quotient.cuh", "  fr_mont_mul(r, a, b);\n}",
              "  mont_mul<8>(r, a, b);\n}")],
    "mulk": [("quotient.cuh", "    times9(y, apb);\n    add(y, y, y);\n",
              "    kc(y, cst, QC_EIGHTEEN);\n    mul(y, y, apb);\n"),
             ("quotient.cuh", "    times9(x, x);\n    add(x, x, x);\n"
              "    times9(y, apb);\n    times9(y, y);\n",
              "    kc(y, cst, QC_EIGHTEEN);\n    mul(x, x, y);\n"
              "    kc(y, cst, QC_81);\n    mul(y, y, apb);\n"),
             ("quotient.cuh", "    times9(x, qd);\n",
              "    kc(y, cst, QC_NINE);\n    mul(x, y, qd);\n"),
             ("quotient.cuh", "    sub(x, b8, bx);",
              "    kc(x, cst, QC_PERM_K1);\n    mul(x, x, bx);"),
             ("quotient.cuh", "    add(x, b8, b4);\n    add(x, x, bx);",
              "    kc(x, cst, QC_PERM_K2);\n    mul(x, x, bx);"),
             ("quotient.cuh", "    add(x, b8, b8);\n    add(x, x, bx);",
              "    kc(x, cst, QC_PERM_K3);\n    mul(x, x, bx);")],
    "pf1": prefetch("L1"),
    "pf2": prefetch("L2"),
    "l1": [("quotient.cuh",
            "const uint32_t* src = base + (int64_t)row * 16 * E + i;",
            "const uint32_t* src = base + (int64_t)row * 16 * E"
            " + (i & 31);")],
}
# name -> (source, -D flags, probes); g{g}m{m}: g groups (probe g3 for
# three), QMINB m, so the register cap is 65,536 / (32 g m)
SHAPES = {"g3m4": (3, 4), "g3m5": (3, 5), "g4m4": (4, 4), "g4m5": (4, 5),
          "g4m6": (4, 6)}
RUNS = (("g3m4", ("h0",)), ("g3m5", ("h0",)), ("g4m4", ("h0",)),
        ("g4m5", ("h0",)), ("g3m5", ("h1",)), ("g4m5", ("h1",)),
        ("g3m5", ()), ("g4m4", ()), ("g4m5", ()), ("g4m6", ()),
        ("g4m5", ("mont",)), ("g4m5", ("mulk",)), ("g4m5", ("h0", "pf1")),
        ("g4m5", ("h0", "pf2")), ("g4m5", ("l1",)))
VARIANTS = {
    "one_thread": ("one_thread", {"QT": 256, "QMINB": 2}, ()),
    **{shape + "".join("_" + p for p in probes): (
        "groups", {"QMINB": SHAPES[shape][1]},
        ("g3",) * (SHAPES[shape][0] == 3) + probes)
       for shape, probes in RUNS},
}
UNHELD = {"g4m5_l1"}
SOURCES = {"one_thread": os.path.join(HERE, "quotient_var.cu"),
           "groups": os.path.join(_build.CSRC_DIR, "quotient.cu")}
P = ctypes.c_void_p


def ptxas_of(log):
    """Registers, spills and stack of the log's kernel entries."""
    return {"registers": [int(x) for x in
                          re.findall(r"Used (\d+) registers", log)],
            "spill_stores_loads": [(int(a), int(b)) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)],
            "stack": [int(x) for x in
                      re.findall(r"(\d+) bytes stack frame", log)]}


def probe_csrc(name, probes):
    """A copy of csrc with every (file, old, new) of the named probes
    substituted once; returns the copy's directory."""
    d = os.path.join(HERE, f"probe_{name}")
    os.makedirs(d, exist_ok=True)
    subs = [sub for p in probes for sub in PROBES[p]]
    for f in os.listdir(_build.CSRC_DIR):
        with open(os.path.join(_build.CSRC_DIR, f)) as g:
            text = g.read()
        for file, old, new in subs:
            if file != f:
                continue
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: probe text not found once: "
                                   f"{old!r}")
            text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as g:
            g.write(text)
    return d


def sass_histogram(lib, kernel):
    """The total and the 14 commonest opcodes of `kernel`'s SASS in `lib`
    (cuobjdump)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True).stdout
    hist, inside = {}, False
    for ln in text.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", ln)
        if inside and m:
            op = m.group(2).split(".")[0]
            hist[op] = hist.get(op, 0) + 1
    top = dict(sorted(hist.items(), key=lambda kv: -kv[1])[:14])
    return {"sass_total": sum(hist.values()), "sass_top": top}


def build(names):
    """Build the named variants in parallel: {name: (C entry, its ptxas
    and SASS counts)}, the package's own build first."""
    procs = []
    for name in names:
        src, defs, probes = VARIANTS[name]
        path = SOURCES[src]
        if probes:
            path = os.path.join(probe_csrc(name, probes),
                                os.path.basename(path))
        out = os.path.join(HERE, f"libq14_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
               "-I", _build.CSRC_DIR,
               *(f"-D{k}={v}" for k, v in defs.items()), "-o", out, path]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {"package": (_build.lib().dt_quotient, {})}
    for name, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        fn = ctypes.CDLL(out).dt_quotient
        fn.argtypes = _build._SIGNATURES["dt_quotient"]
        fn.restype = ctypes.c_int
        kernel = "quotient_one_thread_kernel" if name == "one_thread" \
            else "quotient_groups_kernel"
        fns[name] = fn, {**ptxas_of(log), **sass_histogram(out, kernel)}
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


def mul_peak():
    """Fr multiplies a second on the card: fr_mul_peak.cu's chains."""
    out = os.path.join(HERE, "libfr_mul_peak.so")
    log = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
         "-I", _build.CSRC_DIR, "-o", out,
         os.path.join(HERE, "fr_mul_peak.cu")], capture_output=True,
        text=True)
    if log.returncode:
        raise RuntimeError(log.stdout + log.stderr)
    regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                       log.stdout + log.stderr)]
    fn = ctypes.CDLL(out).dt_fr_mul_peak
    fn.argtypes = [P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 16, 2000
    buf = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")
    stream = P(torch.cuda.current_stream().cuda_stream)
    # dynamic shared memory a block: none, 4 blocks an SM, 2 an SM
    for smem, cap in ((0, "registers"), (56 << 10, "16 warps"),
                      (110 << 10, "8 warps")):
        for shaped in (1, 0):
            for ilp in (1, 2, 4):
                def launch():
                    assert fn(P(buf.data_ptr()), iters, ilp, shaped,
                              blocks, smem, stream) == 0
                med, _ = median_ms(launch, reps=3, runs=3)
                print(json.dumps({
                    "peak": "fr_mont_mul" if shaped else "mont_mul<8>",
                    "ilp": ilp, "occupancy_cap": cap, "ms": med,
                    "fr_muls_per_s": blocks * 128 * iters * ilp
                    / (med * 1e-3)}), flush=True)
    print(json.dumps({"peak_ptxas_registers": regs}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--peak", action="store_true")
    ap.add_argument("--rounds", type=int, default=1, choices=(1, 2))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    opts = ap.parse_args()
    if opts.peak:
        mul_peak()
    fns = build(opts.variants.split(","))
    with open(_build.BUILD_LOG) as f:
        pkg_log = f.read()
    pkg = ptxas_of(pkg_log[pkg_log.find("quotient_groups_kernel"):])
    print(json.dumps({"var": "package", **{k: v[:1] for k, v in
                                           pkg.items()}}), flush=True)
    for name, (_, ptxas) in fns.items():
        if name != "package":
            print(json.dumps({"var": name, "defs": VARIANTS[name][1],
                              "probes": VARIANTS[name][2], **ptxas}),
                  flush=True)
    F = fr_field()
    gen = torch.Generator("cuda").manual_seed(14)
    top = (R_MOD >> 240) >> 1

    def limbs(*shape):          # canonical Fr limbs: the top limb < r's / 2
        x = torch.randint(0, 1 << 16, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
        x[..., 15, :] &= top
        return x

    def grid(E):
        evs = limbs(6, 16, E)
        return (evs, evs[[0, 1, 2, 4], :, :8].contiguous(),
                limbs(11, 16, E), limbs(4, 16, E), limbs(16, E),
                limbs(16, E), limbs(16, E), consts)

    rng = random.Random(14)
    consts = kernels.quotient_consts(F, {
        k: rng.randrange(R_MOD) for k in (
            "alpha", "beta", "gamma", "range_sep", "logic_sep",
            "fixed_base_sep", "var_base_sep")}, "cuda")
    for E in (32, 1000, 1 << 16):
        args = grid(E)
        err = int((kernels.quotient(F, *args).long()
                   - kernels.quotient_plain(F, *args).long()).abs().max())
        print(json.dumps({"kernel": "K14", "E": E, "package_vs_plain":
                          err}), flush=True)
        if err:
            raise AssertionError(f"K14 != plain at E = {E}")
    for log_e in (16, 17, 19, 23):
        E = 1 << log_e
        args = grid(E)
        want = kernels.quotient(F, *args)
        order = list(fns.items())
        if opts.rounds == 2:
            order += order[::-1]
        for name, (fn, ptxas) in order:
            out = torch.zeros_like(want)
            call = [P(t.data_ptr()) for t in args + (out,)] + \
                [E, consts.shape[-1], P(torch.cuda.current_stream()
                                         .cuda_stream)]

            def launch():
                assert fn(*call) == 0
            med, runs = median_ms(launch)
            equal = torch.equal(out, want)
            print(json.dumps({"kernel": "K14", "E": E, "var": name,
                              "equal": equal, "ms": med, "ms_runs": runs,
                              "registers": ptxas.get("registers"),
                              "spills": ptxas.get("spill_stores_loads")}),
                  flush=True)
            if not equal and name not in UNHELD:
                raise AssertionError(f"{name} != package at E = {E}")
        del args, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
