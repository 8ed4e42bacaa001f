"""Build the CUDA kernels and bind them with ctypes.

`nvcc` compiles every `dusk_plonk_torch/csrc/*.cu` for sm_90a, one process
per source, all started together, and links the objects into one shared
library with a plain C interface, under `build/torch_kernels/` at the
repository root (listed in .gitignore).  The build runs at first use, and
again whenever the build key -- a digest of every source, header and
compiler flag, kept beside the library -- differs from the one the library
was built with.  Nothing here includes
PyTorch's headers, so a cold build takes seconds, not minutes.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libdusk_torch_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
KEY_PATH = LIB_PATH + ".key"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int

# name -> argtypes of every C entry point (csrc/*.cu)
_SIGNATURES = {
    "dt_mont_mul": [_I, _P, _I64, _I64, _I64, _P, _I64, _I64, _I64,
                    _P, _I64, _I64, _P],
    "dt_ntt_pass": [_P] * 5 + [_I64, _I, _I, _I] + [_I64] * 7 + [_I, _I, _P],
    "dt_ec_add": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P],
    "dt_ec_add_mixed": [_P] * 8 + [_I64, _I64, _P],
    "dt_ec_scan_mixed": [_P, _P, _P, _P, _I, _I64, _P],
    "dt_ec_scan_mixed_em": [_P, _P, _I, _I64, _I, _P],
    "dt_reduce_planes": [_P, _P, _I64, _I64, _P],
    "dt_ec_sum_steps": [_P] * 6 + [_I, _I64, _I, _I, _P],
    "dt_ec_scan_excl": [_P] * 6 + [_I, _I64, _I, _I, _P],
    "dt_ec_double_add": [_P] * 9 + [_I, _I64, _P],
    "dt_ec_combine": [_P] * 6 + [_I, _I, _I64, _P],
    "dt_quotient": [_P] * 9 + [_I64, _I64, _P],
    "dt_wire_gather": [_P, _P, _P, _I64, _I64, _P],
}

_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_key() -> str:
    """Digest of the compiler flags and every csrc source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(glob.glob(os.path.join(CSRC_DIR,
                                                          "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def _stale() -> bool:
    if not (os.path.exists(LIB_PATH) and os.path.exists(KEY_PATH)):
        return True
    with open(KEY_PATH) as f:
        return f.read() != build_key()


def build() -> None:
    """Compile each csrc/*.cu to an object in parallel (ptxas register
    counts in BUILD_LOG), then link LIB_PATH.  Raises with the compiler's
    errors if any step fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    key = build_key()             # of the sources this build compiles
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src)[:-3] + f".{tag}.o")
        cmd = [nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = f"{LIB_PATH}.{tag}"
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp] + objs
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    with open(BUILD_LOG, "w") as f:
        f.write("\n".join(log))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
    os.replace(tmp, LIB_PATH)     # atomic: concurrent builders never see half
    with open(f"{KEY_PATH}.{tag}", "w") as f:
        f.write(key)
    os.replace(f"{KEY_PATH}.{tag}", KEY_PATH)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        handle = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.dt_error_string.argtypes = [ctypes.c_int]
        handle.dt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().dt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")
