"""ctypes bindings for the C++ host exactness engine (native/dusk_native.cpp).

The port's own binding: at first use it compiles the repository's
`native/dusk_native.cpp` with the host C++ compiler into
`build/native/libdusk_native.so` (gitignored), and again whenever the
source is newer than the library.  A failed build raises with the
compiler's errors; the host modules that treat the engine as an
accelerator (keccak, ChaCha, the host NTT and MSM) then take their
pure-Python paths, and the MSM's window combine raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "dusk_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_SO = os.path.join(BUILD_DIR, "libdusk_native.so")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib = None


def build() -> None:
    """Compile SOURCE into the build directory; raises if the compiler
    fails or is missing."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    res = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, SOURCE],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (rc {res.returncode}):"
                           f"\n{res.stderr[-4000:]}")
    os.replace(tmp, _SO)       # atomic: concurrent builders never see half


def lib():
    """The loaded library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or \
            os.path.getmtime(SOURCE) > os.path.getmtime(_SO):
        build()
    L = ctypes.CDLL(_SO)
    L.dn_keccak_f1600.argtypes = [ctypes.c_char_p]
    L.dn_chacha_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32)]
    L.dn_g1_msm.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p]
    L.dn_fr_ntt.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    L.dn_fr_scale_geo.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p]
    L.dn_miller_loop.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p]
    L.dn_final_exp.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    L.dn_pairing_is_one.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    L.dn_pairing_is_one.restype = ctypes.c_int
    L.dn_g1_combine_windows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p]
    L.dn_miller_nsteps.restype = ctypes.c_int64
    L.dn_g2_prepare.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    L.dn_g2_prepare.restype = ctypes.c_int64
    L.dn_miller_loop_prepared.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    L.dn_pairing_is_one_prepared.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int64]
    L.dn_pairing_is_one_prepared.restype = ctypes.c_int
    _lib = L
    return _lib


def available() -> bool:
    """True once the library is loaded (building it raises on failure)."""
    return lib() is not None


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of the 200-byte state."""
    buf = ctypes.create_string_buffer(bytes(state), 200)
    lib().dn_keccak_f1600(ctypes.cast(buf, ctypes.c_char_p))
    state[:] = buf.raw[:200]


def chacha_blocks(key_words, counter: int, nonce_words, rounds: int,
                  nblocks: int) -> list[int]:
    """nblocks consecutive 64-byte ChaCha blocks -> 16*nblocks u32 words."""
    key = (ctypes.c_uint32 * 8)(*key_words)
    nonce = (ctypes.c_uint32 * 2)(*nonce_words)
    out = (ctypes.c_uint32 * (16 * nblocks))()
    lib().dn_chacha_blocks(key, counter, nonce, rounds, nblocks, out)
    return list(out)


def g1_combine_windows(totals: bytes, b: int, w: int, window_bits: int):
    """Combine per-window MSM totals fetched from the device.

    totals: b*w*144 bytes — per (commit, window, LSB-first) a projective
    Montgomery (X, Y, Z) triple of 48 LE bytes each.  Returns a list of b
    affine host points ((x, y) ints or None for infinity)."""
    out = ctypes.create_string_buffer(96 * b)
    out_inf = ctypes.create_string_buffer(b)
    lib().dn_g1_combine_windows(
        totals, b, w, window_bits,
        ctypes.cast(out, ctypes.c_char_p),
        ctypes.cast(out_inf, ctypes.c_char_p))
    res = []
    raw = out.raw
    for k in range(b):
        if out_inf.raw[k]:
            res.append(None)
        else:
            res.append((int.from_bytes(raw[96 * k:96 * k + 48], "little"),
                        int.from_bytes(raw[96 * k + 48:96 * k + 96],
                                       "little")))
    return res


def g1_msm(points, scalars):
    """Pippenger over affine host points [(x, y) | None] and int scalars."""
    from .fields.constants import R_MOD
    n = len(points)
    pbuf = bytearray(96 * n)
    inf = bytearray(n)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = 1
        else:
            pbuf[96 * i: 96 * i + 48] = int(p[0]).to_bytes(48, "little")
            pbuf[96 * i + 48: 96 * i + 96] = int(p[1]).to_bytes(48, "little")
    sbuf = b"".join(int(s % R_MOD).to_bytes(32, "little") for s in scalars)
    out = ctypes.create_string_buffer(96)
    out_inf = ctypes.create_string_buffer(1)
    lib().dn_g1_msm(bytes(pbuf), bytes(inf), sbuf, n,
                    ctypes.cast(out, ctypes.c_char_p),
                    ctypes.cast(out_inf, ctypes.c_char_p))
    if out_inf.raw[0] == 1:
        return None
    raw = out.raw
    return (int.from_bytes(raw[:48], "little"),
            int.from_bytes(raw[48:96], "little"))


def fr_ntt(values: list[int], root: int) -> list[int]:
    """In-place radix-2 NTT at powers of `root` (natural order in/out)."""
    n = len(values)
    buf = ctypes.create_string_buffer(
        b"".join(int(v).to_bytes(32, "little") for v in values), 32 * n)
    lib().dn_fr_ntt(ctypes.cast(buf, ctypes.c_char_p), n,
                    int(root).to_bytes(32, "little"))
    raw = buf.raw
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(n)]


def fr_scale_geo(values: list[int], s: int, g: int) -> list[int]:
    """[v_i * s * g^i]."""
    n = len(values)
    buf = ctypes.create_string_buffer(
        b"".join(int(v).to_bytes(32, "little") for v in values), 32 * n)
    lib().dn_fr_scale_geo(ctypes.cast(buf, ctypes.c_char_p), n,
                          int(s).to_bytes(32, "little"),
                          int(g).to_bytes(32, "little"))
    raw = buf.raw
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(n)]


# -- pairing (reference src/commitment_scheme.rs:56-62 via unmounted
#    ec-pairing; mirrors curves/pairing.py so the two are differential-
#    testable on full Fq12 values) --------------------------------------------

def _pack_pairs(pairs):
    n = len(pairs)
    g1 = bytearray(96 * n)
    g1i = bytearray(n)
    g2 = bytearray(192 * n)
    g2i = bytearray(n)
    for i, (p, q) in enumerate(pairs):
        if p is None:
            g1i[i] = 1
        else:
            g1[96 * i:96 * i + 48] = int(p[0]).to_bytes(48, "little")
            g1[96 * i + 48:96 * i + 96] = int(p[1]).to_bytes(48, "little")
        if q is None:
            g2i[i] = 1
        else:
            (x0, x1), (y0, y1) = q
            o = 192 * i
            g2[o:o + 48] = int(x0).to_bytes(48, "little")
            g2[o + 48:o + 96] = int(x1).to_bytes(48, "little")
            g2[o + 96:o + 144] = int(y0).to_bytes(48, "little")
            g2[o + 144:o + 192] = int(y1).to_bytes(48, "little")
    return bytes(g1), bytes(g1i), bytes(g2), bytes(g2i), n


def _fq12_from_bytes(raw):
    vals = [int.from_bytes(raw[48 * i:48 * i + 48], "little")
            for i in range(12)]
    return (((vals[0], vals[1]), (vals[2], vals[3]), (vals[4], vals[5])),
            ((vals[6], vals[7]), (vals[8], vals[9]), (vals[10], vals[11])))


def _fq12_to_bytes(f):
    flat = [c for fq6 in f for fq2 in fq6 for c in fq2]
    return b"".join(int(v).to_bytes(48, "little") for v in flat)


def miller_loop(pairs):
    """Product of Miller loops; returns a host Fq12 tuple."""
    g1, g1i, g2, g2i, n = _pack_pairs(pairs)
    out = ctypes.create_string_buffer(576)
    lib().dn_miller_loop(g1, g1i, g2, g2i, n,
                         ctypes.cast(out, ctypes.c_char_p))
    return _fq12_from_bytes(out.raw)


def final_exp(f):
    """Full final exponentiation of a host Fq12 tuple."""
    from .curves.pairing import _HARD_EXP
    he = int(_HARD_EXP).to_bytes((_HARD_EXP.bit_length() + 7) // 8, "little")
    out = ctypes.create_string_buffer(576)
    lib().dn_final_exp(_fq12_to_bytes(f), he, len(he),
                       ctypes.cast(out, ctypes.c_char_p))
    return _fq12_from_bytes(out.raw)


def pairing_is_one(pairs) -> bool:
    """multi_miller_loop(pairs).final_exp() == Gt identity, natively."""
    from .curves.pairing import _HARD_EXP
    g1, g1i, g2, g2i, n = _pack_pairs(pairs)
    he = int(_HARD_EXP).to_bytes((_HARD_EXP.bit_length() + 7) // 8, "little")
    return bool(lib().dn_pairing_is_one(g1, g1i, g2, g2i, n, he, len(he)))


# -- prepared-G2 pairing (reference EvaluationKey's prepared_h /
#    prepared_beta_h, src/commitment_scheme.rs:51-58) ----------------------

_LINESTEP = 288  # sizeof(LineStep): 3 Fq2 x 96B, raw Montgomery (opaque)


def has_prepared_pairing() -> bool:
    return available()


def miller_nsteps() -> int:
    return int(lib().dn_miller_nsteps())


def g2_prepare(q) -> bytes:
    """Precompute the Miller-loop line coefficients of a fixed G2 point
    (one ~18 ms affine loop, paid once per verification key); returns an
    opaque buffer for pairing_is_one_prepared.  b'' for the identity."""
    if q is None:
        return b""
    (x0, x1), (y0, y1) = q
    raw = (int(x0).to_bytes(48, "little") + int(x1).to_bytes(48, "little")
           + int(y0).to_bytes(48, "little") + int(y1).to_bytes(48, "little"))
    out = ctypes.create_string_buffer(miller_nsteps() * _LINESTEP)
    k = lib().dn_g2_prepare(raw, 0, ctypes.cast(out, ctypes.c_char_p))
    assert k == miller_nsteps()
    return out.raw


def pairing_is_one_prepared(g1_points, prepared) -> bool:
    """Batched pairing-identity check with prepared G2 line buffers
    (g2_prepare); pure Fq12 accumulation — no per-step inversions."""
    from .curves.pairing import _HARD_EXP  # noqa: F401  (parity w/ slow path)
    n = len(g1_points)
    assert len(prepared) == n
    g1buf = bytearray(96 * n)
    g1inf = bytearray(n)
    active = bytearray(n)
    lines = bytearray(miller_nsteps() * _LINESTEP * n)
    for i, (p, pre) in enumerate(zip(g1_points, prepared)):
        if p is None:
            g1inf[i] = 1
        else:
            g1buf[96 * i:96 * i + 48] = int(p[0]).to_bytes(48, "little")
            g1buf[96 * i + 48:96 * i + 96] = int(p[1]).to_bytes(48, "little")
        if pre:
            active[i] = 1
            off = i * miller_nsteps() * _LINESTEP
            lines[off:off + len(pre)] = pre
    return bool(lib().dn_pairing_is_one_prepared(
        bytes(g1buf), bytes(g1inf), bytes(lines), bytes(active), n))
