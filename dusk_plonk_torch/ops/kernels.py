"""The port's thirteen hand-written CUDA kernels, each with its plain PyTorch
version and a launch counter.

| wrapper          | kernel (csrc/)        | replaces (dusk_plonk_tpu/ops/)     |
|------------------|-----------------------|------------------------------------|
| mont_mul         | K1  mont_mul.cu       | pallas_field.py::mont_mul          |
| ntt              | K2  ntt.cu            | pallas_field.py::ntt_ladder        |
| ec_add           | K9  ec_add.cu         | pallas_field.py::ec_add, ec_add14  |
| ec_add_mixed     | K10 ec_add_mixed.cu   | pallas_field.py::ec_add_mixed      |
| ec_scan_mixed    | K11a ec_scan.cu       | ::ec_scan_mixed, ec_scan_mixed14   |
| ec_scan_mixed_em | K12 ec_scan_em.cu     | ::ec_scan_mixed14_em               |
| ec_sum_steps     | K11b ec_sum.cu        | ::ec_sum_steps, ec_sum_steps14     |
| ec_scan_excl     | K4  ec_scan_excl.cu   | ::ec_scan_excl14                   |
| ec_double_add    | K7  ec_double_add.cu  | ::ec_double_add14                  |
| ec_combine       | K8  ec_combine.cu     | ::ec_combine14                     |
| reduce_planes    | K13 reduce_planes.cu  | mxu_ntt.py::reduce_planes          |
| quotient         | K14 quotient.cu       | no pallas_call site: the XLA       |
|                  |                       | fusion of round3b, dusk_plonk_tpu/ |
|                  |                       | proving/engine.py:465-524          |
| wire_gather      | K15 wire_gather.cu    | no TPU kernel: the host's numpy    |
|                  |                       | gather, dusk_plonk_tpu/proving/    |
|                  |                       | engine.py:190-194                  |

The JAX package's 14-bit kernels (R = 2^392, lazy 14-bit limbs) answer the
TPU's missing 32x32->64 multiply; on Hopper one 32-bit-word engine gives
the same group elements, so each 14-bit row merges into its 16-bit
counterpart (the 14-bit outputs are the same points, projectively scaled).

The EC wrappers take and return projective points as ((..., 24, N),)*3
tuples of int32 Montgomery limb planes, the layout of ops/ec.py.

Rules every wrapper keeps: on CPU tensors it runs the plain version; on
CUDA tensors it launches its kernel or raises (there is no fallback).  It
checks dtype, shape and contiguity, allocates outputs with torch.empty,
launches on its tensors' device and that device's current stream
(`_launch`), and adds one to its `launches` count at each kernel launch
and nowhere else.  The `*_plain` functions run
on any device and never launch a kernel: the CPU path and the on-card
comparisons use them.

Field and point arguments are the objects of ops/limb.py (`F`, a
LimbField) and ops/ec.py (`G1`, a DeviceG1).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..fields.constants import JUBJUB_D, PERM_K1, PERM_K2, PERM_K3
from . import _build

MASK16 = 0xFFFF


def _is_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) > 1:
        raise ValueError(f"operands on mixed devices: "
                         f"{sorted({str(t.device) for t in ts})}")
    return False


def _check_int32(*ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors must be int32, got {t.dtype}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(entry, t, *args):
    """Call the C entry point `entry` with `args` and a stream, on the
    device of tensor t: that device made current for the launch, and its
    current stream, so that a shard on another card launches there."""
    with torch.cuda.device(t.device):
        return entry(*args, _stream(t.device))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _wrappers():
    return (mont_mul, ntt, ec_add, ec_add_mixed, ec_scan_mixed,
            ec_scan_mixed_em, ec_sum_steps, ec_scan_excl, ec_double_add,
            ec_combine, reduce_planes, quotient, wire_gather)


def reset_launches() -> None:
    for fn in _wrappers():
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


# -- carries of 16-bit limb rows (shared by every plain version) ------------------

@lru_cache(maxsize=None)
def _row_bits(K: int, device: str):
    return torch.arange(K, dtype=torch.int64, device=device)[:, None]


def resolve_carries(s):
    """Carry resolution of limb rows each < 2^17 (axis -2) -> (16-bit
    limbs, carry out of the top row).  The generate / propagate flags of
    the K <= 62 rows pack into the bits of one int64 per element, and one
    integer addition resolves the whole chain: the result of the JAX
    package's Kogge-Stone ladder in a constant number of tensor ops."""
    K = s.shape[-2]
    sh = _row_bits(K, str(s.device))
    g = ((s >> 16).long() << sh).sum(dim=-2)
    p = (((s & MASK16) == MASK16).long() << sh).sum(dim=-2)
    b = g | p
    c = (g + b) ^ g ^ b                  # bit i: carry into row i
    cin = (c.unsqueeze(-2) >> sh) & 1
    return (s + cin.to(s.dtype)) & MASK16, ((c >> K) & 1) != 0


def fold(t):
    """Move each row's bits above 16 one row up (value kept mod
    2^(16 rows))."""
    out = t & MASK16
    out[..., 1:, :] += (t >> 16)[..., :-1, :]
    return out


def carry(t):
    """Lazy rows (< 2^22) -> 16-bit limbs, mod 2^(16 rows)."""
    return resolve_carries(fold(t))[0]


# -- K1: Montgomery multiply ------------------------------------------------------

def _antidiag(p):
    """p (..., L, L, N) with p[..., i, j, :] = a_i b_j -> (..., 2L+1, N)
    column sums over i + j = k (pad-reshape binning, as LimbField.
    _antidiag_sums)."""
    L = p.shape[-3]
    n = p.shape[-1]
    lead = p.shape[:-3]
    padded = torch.nn.functional.pad(p, (0, 0, 0, L + 2))
    flat = padded.reshape(lead + (L * (2 * L + 2), n))
    w = 2 * L + 1
    return flat[..., :L * w, :].reshape(lead + (L, w, n)).sum(dim=-3)


def _const_columns(F, name, x):
    """Product columns of int64 limbs x (..., L, N) times the constant
    `name` of F, as one float64 matmul with the constant's (2L+1, L)
    Toeplitz matrix: every product and column sum is an integer below
    2^38, so float64 holds it exactly."""
    return torch.matmul(F.toeplitz(name, x.device), x.double()).long()


def _normalize(t):
    """int64 rows < 2^38 -> 16-bit limbs mod 2^(16 rows): two folds bring
    every row under 2^17, then one carry resolution."""
    return resolve_carries(fold(fold(t)))[0]


# elements a call of mont_mul_plain takes at once: its int64 temporaries
# take ~7 KB an element, so larger operands go in chunks along the
# element axis (a 2^23-point oracle on the card)
PLAIN_MUL_ELEMS = 1 << 21


def mont_mul_plain(F, a, b):
    """K1's plain version: LimbField._mul_xla's separated Montgomery
    product T = ab; m = (T mod R) N' mod R; (T + mN) / R, then one
    conditional subtraction.  Computes in int64; returns int32."""
    L = F.L
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    step = max(PLAIN_MUL_ELEMS // max(a[..., 0, :1].numel(), 1), 1)
    if n > step:
        return torch.cat([mont_mul_plain(F, a[..., i:i + step],
                                         b[..., i:i + step])
                          for i in range(0, n, step)], dim=-1)
    a, b = a.long(), b.long()
    t = _normalize(_antidiag(a[..., :, None, :] * b[..., None, :, :]))
    m = _normalize(_const_columns(F, "nprime", t[..., :L, :])[..., :L, :])
    full = _normalize(t + _const_columns(F, "mod", m))
    return F._cond_sub_mod(full[..., L:2 * L, :]).to(torch.int32)


def _row_strides(t, shape):
    """Broadcast `t` to `shape` (..., L, N) and return (tensor, (row, limb,
    elem) element strides) with all leading axes folded into one row
    axis; a tensor whose leading axes cannot fold is copied."""
    e = t.expand(shape)
    lead = [(sz, st) for sz, st in zip(shape[:-2], e.stride()[:-2])
            if sz != 1]
    foldable = all(st0 == st1 * sz1
                   for (_, st0), (sz1, st1) in zip(lead, lead[1:]))
    if not foldable:
        e = e.contiguous()
        lead = [(sz, st) for sz, st in zip(shape[:-2], e.stride()[:-2])
                if sz != 1]
    row = lead[-1][1] if lead else 0
    return e, (row, e.stride()[-2], e.stride()[-1])


def mont_mul(F, a, b):
    """a * b * R^-1 mod p on (..., L, N) limb tensors; broadcasts."""
    if _is_cpu(a, b):
        return mont_mul_plain(F, a, b)
    _check_int32(a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if len(shape) < 2 or shape[-2] != F.L:
        raise ValueError(f"mont_mul: limb axis must be {F.L}, got {shape}")
    rows = math.prod(shape[:-2])
    n = shape[-1]
    ea, sa = _row_strides(a, shape)
    eb, sb = _row_strides(b, shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    rc = _launch(_build.lib().dt_mont_mul, out,
                 F.L, _ptr(ea), *sa, _ptr(eb), *sb, _ptr(out), rows, n)
    mont_mul.launches += 1
    _build.check(rc, "mont_mul")
    return out


# -- K2: multi-pass NTT ------------------------------------------------------------

def ntt_ladder_plain(F, x, tw, k: int):
    """The radix-2 ladder of earlier versions, kept as the oracle of K2's
    tests: the k DIT stages on bit-reversed (..., 16, n) input; tw (16,
    n/2) holds the powers of the n-th root."""
    n = 1 << k
    j = torch.arange(n, device=x.device)
    for s in range(k):
        half = 1 << s
        tw_vec = tw[:, (j & (half - 1)) << (k - 1 - s)]     # (16, n)
        t = mont_mul_plain(F, x, tw_vec)
        tr = torch.roll(t, -half, dims=-1)                  # t[j + half]
        xl = torch.roll(x, half, dims=-1)                   # x[j - half]
        x = F.select((j & half) == 0, F.add(x, tr), F.sub(xl, t))
    return x


NTT_TILE = 2048        # elements of one K2 tile: 8 words each, 64 KB
NTT_RUN = 8            # adjacent lines a tile reads or writes on a strided
                       # side: one 32-byte sector in every limb plane
NTT_ONE_PASS_K = 10    # one pass up to 2^10 points


@dataclass(frozen=True)
class NttPass:
    """One K2 launch: an m-point DFT (m = 2^log_m) on each line of the
    array, `lines` lines a tile.  Line l = hi D + lo holds its DFT position
    a at hi in_a + lo in_b + a in_s of the input and writes its output
    position c to hi out_a + lo out_b + c out_s.  `mid` is the order N of
    the mid twiddle w_N^(lo c) applied to the output (0: none, the last
    pass, which applies the post-scale instead)."""
    log_m: int
    lines: int
    D: int
    in_a: int
    in_b: int
    in_s: int
    out_a: int
    out_b: int
    out_s: int
    mid: int


def ntt_passes(k: int, passes=None):
    """K2's passes for a 2^k-point transform (the Bailey split, natural
    order in and out).  One pass up to k = 10 (the tile is one transform);
    above, the fewest passes P whose tiles hold NTT_RUN lines of at most
    NTT_TILE / NTT_RUN = 256 points: P = ceil(k / 8), the levels split as
    evenly as possible, the larger parts last (k = 16: 8 + 8; 19: 6 + 6 +
    7; 23: 7 + 8 + 8), at most three (k <= 24; the line offsets below are
    two-level).  `passes` forces the count (tests).  The shapes
    depend on k alone: the batch is the launch grid's second axis.

    With n = m_1 .. m_P, S_p = m_{p+1} .. m_P, L_p = m_1 .. m_{p-1}: pass p
    < P takes the DFT over the digit of stride S_p in place on the L_p S_p
    lines (q, b), q N_p + b (N_p = m_p S_p), C = min(8, S_p) adjacent b a
    tile, and multiplies output c of line b by w_{N_p}^(b c).  The last
    pass takes the rows (contiguous, m_P long) in the order of the output's
    low digits c_1 + m_1 c_2 + .., reads row c_1 S_1 + c_2 S_2 + .. and
    writes position c to (its line) + L_P c, C = min(8, m_1) adjacent c_1
    a tile."""
    max_log = (NTT_TILE // NTT_RUN).bit_length() - 1
    P = passes or (1 if k <= NTT_ONE_PASS_K else -(-k // max_log))
    if not 1 <= P <= 3 or (P > 1 and k < P) or \
            (P == 1 and (1 << k) > NTT_TILE):
        raise ValueError(f"ntt_passes: no {P}-pass plan for k = {k}")
    logs = [(k + i) // P for i in range(P)]
    out = []
    for i, lm in enumerate(logs):
        m = 1 << lm
        S = 1 << sum(logs[i + 1:])
        L = 1 << sum(logs[:i])
        if i < P - 1:
            C = min(NTT_RUN, S)
            p = NttPass(lm, C, S, m * S, 1, S, m * S, 1, S, m * S)
        else:
            D = 1 << logs[0] if P > 1 else 1
            C = min(NTT_RUN, D)
            S1 = 1 << sum(logs[1:]) if P > 1 else 0
            p = NttPass(lm, C, D, m, S1, 1, D, 1, L, 0)
        if p.lines << lm > NTT_TILE:
            raise ValueError(f"ntt_passes: k = {k} needs more passes")
        out.append(p)
    return tuple(out)


def pack_words(limbs):
    """(16, N) int32 16-bit limbs -> (N, 8) int32 32-bit words (each
    element's 8 words adjacent, 32 bytes: K2's table layout)."""
    w = limbs[0::2].long() | (limbs[1::2].long() << 16)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.to(torch.int32).t().contiguous()


def unpack_words(words):
    """(N, 8) words -> (16, N) limbs, the inverse of pack_words."""
    w = words.t()
    return torch.stack([w & MASK16, (w >> 16) & MASK16], dim=1) \
        .reshape(16, -1)


@lru_cache(maxsize=None)
def bitrev_indices(log_m: int, device: str):
    idx = torch.arange(1 << log_m, dtype=torch.int64)
    out = torch.zeros_like(idx)
    for b in range(log_m):
        out |= ((idx >> b) & 1) << (log_m - 1 - b)
    return out.to(device)


def _pass_index(p: NttPass, n: int, device):
    """(src, dst, lo) of a pass: (lines, m) input and output positions,
    and (lines, 1) the low part of each line index."""
    m = 1 << p.log_m
    line = torch.arange(n // m, device=device)[:, None]
    a = torch.arange(m, device=device)[None]
    hi, lo = line // p.D, line % p.D
    return (hi * p.in_a + lo * p.in_b + a * p.in_s,
            hi * p.out_a + lo * p.out_b + a * p.out_s, lo)


def ntt_plain(F, x, k: int, steps, pre=None, post=None):
    """K2's plain version: the kernel's passes in torch, each on all lines
    at once.  steps: ((NttPass, roots (m/2, 8), mid (N, 8) or None),) as
    NttPlan builds them; pre: (n, 8) table or None; post: (1, 8) scalar,
    (n, 8) table or None (packed words)."""
    n = 1 << k
    y = x.reshape((-1, 16, n))
    mul = F.mul_plain
    for i, (p, roots, mid) in enumerate(steps):
        src, dst, lo = _pass_index(p, n, x.device)
        v = y[..., src].movedim(1, -2)                   # (B, lines, 16, m)
        if i == 0 and pre is not None:
            v = mul(v, unpack_words(pre)[:, src].movedim(0, -2))
        v = v.index_select(-1, bitrev_indices(p.log_m, str(x.device)))
        v = ntt_ladder_plain(F, v, unpack_words(roots), p.log_m)
        c = torch.arange(1 << p.log_m, device=x.device)[None]
        if p.mid:
            v = mul(v, unpack_words(mid)[:, c * p.D + lo].movedim(0, -2))
        elif post is not None:
            scale = unpack_words(post)
            v = mul(v, scale if post.shape[0] == 1
                    else scale[:, dst].movedim(0, -2))
        out = torch.empty_like(y)
        out[..., dst] = v.movedim(-2, 1)
        y = out
    return y.reshape(x.shape)


def _check_table(name, t, rows):
    if t.dtype != torch.int32 or t.shape != (rows, 8) \
            or not t.is_contiguous() or t.data_ptr() % 32:
        raise ValueError(f"ntt: {name} must be a contiguous, 32-byte "
                         f"aligned ({rows}, 8) int32 table, got "
                         f"{tuple(t.shape)} {t.dtype}")


def ntt(F, x, k: int, steps, pre=None, post=None):
    """The DFT of (..., 16, 2^k) Fr Montgomery limbs along the element
    axis, natural order in and out, with the pre-scale (before) and the
    post-scale (after) folded in: one K2 launch a pass (ntt_passes).
    Arguments as for ntt_plain."""
    if _is_cpu(x, *(t for _, r, d in steps for t in (r, d) if t is not None)):
        return ntt_plain(F, x, k, steps, pre, post)
    _check_int32(x)
    n = 1 << k
    if x.shape[-2:] != (16, n):
        raise ValueError(f"ntt: expected (..., 16, {n}), got {x.shape}")
    if pre is not None:
        _check_table("pre", pre, n)
    if post is not None:
        _check_table("post", post, post.shape[0])
        if post.shape[0] not in (1, n):
            raise ValueError("ntt: post must be a scalar or an n table")
    src = x.reshape(-1, 16, n).contiguous()
    batch = src.shape[0]
    bufs = (torch.empty_like(src), torch.empty_like(src))
    lib = _build.lib()
    null = ctypes.c_void_p(0)
    for i, (p, roots, mid) in enumerate(steps):
        _check_table("roots", roots, max((1 << p.log_m) // 2, 1))
        if p.mid:
            _check_table("mid", mid, p.mid)
            post_t, post_mode = mid, 3
        elif post is not None:
            post_t, post_mode = post, 1 if post.shape[0] == 1 else 2
        else:
            post_t, post_mode = None, 0
        pre_t = pre if i == 0 else None
        dst = bufs[i % 2]
        rc = _launch(
            lib.dt_ntt_pass, src, _ptr(src), _ptr(dst), _ptr(roots),
            null if pre_t is None else _ptr(pre_t),
            null if post_t is None else _ptr(post_t), batch, k, p.log_m,
            p.lines, p.D, p.in_a, p.in_b, p.in_s, p.out_a, p.out_b, p.out_s,
            int(pre_t is not None), post_mode)
        ntt.launches += 1
        _build.check(rc, "ntt")
        src = dst
    return src.reshape(x.shape)


# -- K9: complete projective G1 addition ------------------------------------------------

def ec_add_plain(G1, p, q):
    """K9's plain version: DeviceG1's RCB15 formula with K1's plain mul."""
    return G1.add_formula(p, q, G1.F.mul_plain)


def ec_add(G1, p, q):
    """p + q on ((..., 24, N),)*3 projective Montgomery points of one
    shape."""
    if _is_cpu(*p, *q):
        return ec_add_plain(G1, p, q)
    _check_int32(*p, *q)
    shape = p[0].shape
    if len(shape) < 2 or shape[-2] != 24:
        raise ValueError(f"ec_add: expected (..., 24, N), got {shape}")
    for c in p + q:
        if c.shape != shape or not c.is_contiguous():
            raise ValueError("ec_add: operands must be contiguous, one shape")
    rows = math.prod(shape[:-2])
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    rc = _launch(_build.lib().dt_ec_add, out[0],
                 *(_ptr(c) for c in p + q + out), rows, shape[-1])
    ec_add.launches += 1
    _build.check(rc, "ec_add")
    return out


# -- K10: complete mixed addition ---------------------------------------------------------

def ec_add_mixed_plain(G1, p, q2):
    """K10's plain version: DeviceG1's RCB15 mixed formula with K1's plain
    mul."""
    return G1.add_mixed_formula(p, q2, G1.F.mul_plain)


def ec_add_mixed(G1, p, q2):
    """p + (x2, y2) on (..., 24, N) Montgomery planes of one shape, q2
    strictly affine (z = 1, never the identity), on a team of six threads
    a lane; limb for limb the plain version."""
    if _is_cpu(*p, *q2):
        return ec_add_mixed_plain(G1, p, q2)
    _check_int32(*p, *q2)
    shape = p[0].shape
    if len(shape) < 2 or shape[-2] != 24:
        raise ValueError(f"ec_add_mixed: expected (..., 24, N), got {shape}")
    for c in p + q2:
        if c.shape != shape or not c.is_contiguous():
            raise ValueError("ec_add_mixed: operands must be contiguous, "
                             "one shape")
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    rc = _launch(_build.lib().dt_ec_add_mixed, out[0],
                 *(_ptr(c) for c in p + q2 + out), math.prod(shape[:-2]),
                 shape[-1])
    ec_add_mixed.launches += 1
    _build.check(rc, "ec_add_mixed")
    return out


# -- K11a: mixed-add prefix scan -------------------------------------------------------

def ec_scan_mixed_plain(G1, g):
    """K11a's plain version: a step loop of the RCB15 mixed add with K1's
    plain mul, from the identity."""
    cl, _, lanes = g.shape
    acc = G1.broadcast_identity((), lanes, g.device)
    outs = []
    for s in range(cl):
        acc = G1.add_mixed_formula(acc, (g[s, :24], g[s, 24:]),
                                   G1.F.mul_plain)
        outs.append(acc)
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def ec_scan_mixed(G1, g):
    """g (cl, 48, lanes): per step the affine (x, y) added on each lane ->
    the inclusive prefix sums ((cl, 24, lanes),)*3 from the identity."""
    if _is_cpu(g):
        return ec_scan_mixed_plain(G1, g)
    _check_scan_input("ec_scan_mixed", g)
    cl, _, lanes = g.shape
    out = tuple(torch.empty((cl, 24, lanes), dtype=torch.int32,
                            device=g.device) for _ in range(3))
    rc = _launch(_build.lib().dt_ec_scan_mixed, g,
                 _ptr(g), *(_ptr(c) for c in out), cl, lanes)
    ec_scan_mixed.launches += 1
    _build.check(rc, "ec_scan_mixed")
    return out


def _check_scan_input(name, g):
    _check_int32(g)
    if g.dim() != 3 or g.shape[1] != 48 or not g.is_contiguous():
        raise ValueError(f"{name}: expected contiguous (cl, 48, lanes), "
                         f"got {tuple(g.shape)}")


# -- K12: mixed-add prefix scan, element-major output ----------------------------------

# K12's threads a mixed add by lane count, from its C-entry times on the
# H100 (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_variants/
# k12_variants.py, cl = 256; ms at 5,140 / 10,280 / 20,560 / 77,100
# lanes): a team of six 1.485 / 2.556 / 4.870 / 17.372, of three 1.772 /
# 2.259 / 4.506 / 15.261, one thread 4.222 / 4.237 / 5.351 / 12.934.  Each
# team up to the widest lane count where it was the fastest.
SCAN_TEAM_LANES = ((5140, 6), (20560, 3))


def _scan_team(lanes: int) -> int:
    """K12's threads a lane: the first team of SCAN_TEAM_LANES whose lane
    count reaches `lanes`, else one thread."""
    return next((N for top, N in SCAN_TEAM_LANES if lanes <= top), 1)


def ec_scan_mixed_em_plain(G1, g):
    """K12's plain version: K11a's plain scan, re-laid-out element-major."""
    ps = ec_scan_mixed_plain(G1, g)
    return torch.cat(ps, dim=1).transpose(1, 2).contiguous()


def ec_scan_mixed_em(G1, g):
    """g (cl, 48, lanes) as for ec_scan_mixed -> (cl, lanes, 72): row
    (s, lane) is that lane's running sum after step s, x, y, z as 24 limbs
    each, in one launch of _scan_team's team size; limb for limb the plain
    version whatever the team."""
    if _is_cpu(g):
        return ec_scan_mixed_em_plain(G1, g)
    _check_scan_input("ec_scan_mixed_em", g)
    cl, _, lanes = g.shape
    out = torch.empty((cl, lanes, 72), dtype=torch.int32, device=g.device)
    rc = _launch(_build.lib().dt_ec_scan_mixed_em, g,
                 _ptr(g), _ptr(out), cl, lanes, _scan_team(lanes))
    ec_scan_mixed_em.launches += 1
    _build.check(rc, "ec_scan_mixed_em")
    return out


# -- K11b, K4, K7, K8: step-axis EC kernels ---------------------------------------------

def _check_points(name, pts, ndim):
    """Three contiguous int32 (..., 24, lanes) planes of one shape with
    `ndim` axes; returns the shape."""
    _check_int32(*pts)
    shape = pts[0].shape
    if len(shape) != ndim or shape[-2] != 24:
        raise ValueError(f"{name}: expected {ndim}-d (..., 24, lanes) "
                         f"planes, got {tuple(shape)}")
    for c in pts:
        if c.shape != shape or not c.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous, one shape")
    return shape


def _empty_points(shape, like):
    return tuple(torch.empty(shape, dtype=torch.int32, device=like.device)
                 for _ in range(3))


def _run_steps(g, T: int, m: int, j: int):
    """Step j of each of T runs of m consecutive steps: ((T, 1, 1) in
    range, ((T, 24, lanes),)*3 points; a step past the end repeats the
    last)."""
    steps = g[0].shape[0]
    s = torch.arange(T, device=g[0].device) * m + j
    return (s < steps)[:, None, None], \
        tuple(c[s.clamp(max=steps - 1)] for c in g)


def _run_totals(G1, g, T: int, m: int):
    """The sum of each run of m steps from the identity, steps past the end
    skipped: ((T, 24, lanes),)*3 (the first phase of K11b and K4)."""
    mul = G1.F.mul_plain
    acc = G1.broadcast_identity((T,), g[0].shape[-1], g[0].device)
    for j in range(m):
        valid, gs = _run_steps(g, T, m, j)
        acc = tuple(torch.where(valid, n, a) for n, a in
                    zip(G1.add_formula(acc, gs, mul), acc))
    return acc


def _check_block(name, block, steps):
    T, m = block
    if T < 1 or T * m < steps:
        raise ValueError(f"{name}: block {block} misses steps")


def ec_sum_steps_plain(G1, g, block=None):
    """K11b's plain version: the sum along the step axis (RCB15 with K1's
    plain mul).

    block=None: acc = identity, then acc + g_s for each step, the JAX
    kernel's order.  block=(T, m): the kernel's order, each pass batched
    over all runs and lanes: the sum of each run of m steps from the
    identity, then a tree over the T run totals (v_r <- v_r + v_{r+d} for
    r = 0 mod 2d, d = 1, 2, .., T/2).  The same group element, another
    representative."""
    steps, _, lanes = g[0].shape
    mul = G1.F.mul_plain
    if block is None:
        acc = G1.broadcast_identity((), lanes, g[0].device)
        for s in range(steps):
            acc = G1.add_formula(acc, tuple(c[s] for c in g), mul)
        return acc
    _check_block("ec_sum_steps", block, steps)
    if block[0] & (block[0] - 1):
        raise ValueError(f"ec_sum_steps: T = {block[0]} is no power of two")
    acc = _run_totals(G1, g, *block)
    while acc[0].shape[0] > 1:      # compacted: v_r, v_{r+d} stand side by side
        acc = G1.add_formula(tuple(c[0::2] for c in acc),
                             tuple(c[1::2] for c in acc), mul)
    return tuple(c[0] for c in acc)


# K11b threads in one wave on the H100: two 128-thread blocks (~188
# registers a thread) on each of its 132 SMs
SUM_FILL = 2 * 128 * 132


def _sum_block(steps: int, lanes: int):
    """K11b's block shape for `steps` steps on `lanes` lanes: (T, m), T
    threads a lane each summing a run of m consecutive steps.  T is the
    largest power of two with lanes * T <= SUM_FILL (the launch fits one
    wave: a second wave costs more than the shorter chain saves), at least
    1, at most 64 and at most `steps`; m = ceil(steps / T)."""
    fit = max(SUM_FILL // max(lanes, 1), 1)
    T = 1 << (min(fit, 64, max(steps, 1)).bit_length() - 1)
    return T, -(-steps // T)


def ec_sum_steps(G1, g):
    """g ((steps, 24, lanes),)*3 -> ((24, lanes),)*3, the sum along the
    step axis, in one launch of the block-parallel tree sum (_sum_block);
    the CPU route runs the same order."""
    steps, _, lanes = g[0].shape
    block = _sum_block(steps, lanes)
    if _is_cpu(*g):
        return ec_sum_steps_plain(G1, g, block)
    _check_points("ec_sum_steps", g, 3)
    out = _empty_points((24, lanes), g[0])
    rc = _launch(_build.lib().dt_ec_sum_steps, g[0],
                 *(_ptr(c) for c in g + out), steps, lanes, *block)
    ec_sum_steps.launches += 1
    _build.check(rc, "ec_sum_steps")
    return out


def _excl_block(steps: int):
    """K4's block shape for `steps` steps: (T, m), T threads a lane (a power
    of two, at most 128) each owning a run of m consecutive steps, T m >=
    steps."""
    T = min(128, 1 << max(0, steps - 1).bit_length())
    return T, -(-steps // T)


def ec_scan_excl_plain(G1, g, block=None):
    """K4's plain version: out_0 = identity, out_s = out_{s-1} + g_{s-1}.

    block=None: the sequential loop, the JAX kernel's order.  block=(T, m):
    the kernel's order, each pass batched over all runs and lanes: the sum
    of each run of m steps from the identity, a Hillis-Steele scan of the T
    run totals (v_r <- v_{r-d} + v_r), then each run's prefixes from its
    exclusive offset.  The same group elements, other representatives."""
    steps, _, lanes = g[0].shape
    mul = G1.F.mul_plain
    if block is None:
        acc = G1.broadcast_identity((), lanes, g[0].device)
        outs = []
        for s in range(steps):
            outs.append(acc)
            acc = G1.add_formula(acc, tuple(c[s] for c in g), mul)
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))

    _check_block("ec_scan_excl", block, steps)
    T, m = block
    acc = _run_totals(G1, g, T, m)                       # 1. run totals
    d = 1
    while d < T:                                         # 2. block scan
        new = G1.add_formula(tuple(c[:-d] for c in acc),
                             tuple(c[d:] for c in acc), mul)
        acc = tuple(torch.cat([c[:d], n]) for c, n in zip(acc, new))
        d <<= 1
    ident = G1.broadcast_identity((1,), lanes, g[0].device)
    acc = tuple(torch.cat([i, c[:-1]]) for i, c in zip(ident, acc))
    outs = []
    for j in range(m):                                   # 3. prefixes
        outs.append(acc)
        if j + 1 < m:
            # past the end of a run the sums only reach steps >= `steps`,
            # which are cut off below
            acc = G1.add_formula(acc, _run_steps(g, T, m, j)[1], mul)
    return tuple(torch.stack([o[i] for o in outs], dim=1)
                 .reshape(T * m, 24, lanes)[:steps] for i in range(3))


def ec_scan_excl(G1, g):
    """g ((steps, 24, lanes),)*3 -> ((steps, 24, lanes),)*3 exclusive
    prefix sums per lane (identity at step 0), in one launch of the
    block-parallel scan (_excl_block); the CPU route runs the same order."""
    steps = g[0].shape[0]
    if _is_cpu(*g):
        return ec_scan_excl_plain(G1, g, _excl_block(steps))
    shape = _check_points("ec_scan_excl", g, 3)
    out = _empty_points(shape, g[0])
    T, m = _excl_block(steps)
    rc = _launch(_build.lib().dt_ec_scan_excl, g[0],
                 *(_ptr(c) for c in g + out), steps, shape[-1], T, m)
    ec_scan_excl.launches += 1
    _build.check(rc, "ec_scan_excl")
    return out


def ec_double_add_plain(G1, a, b, k: int, doubling=True):
    """K7's plain version: k doublings by DeviceG1.double_formula, then + b
    (the kernel's order).  doubling=False doubles with the complete add
    a + a, the JAX kernel's order: the same group element in another
    representative (compare in affine form)."""
    mul = G1.F.mul_plain
    for _ in range(k):
        a = G1.double_formula(a, mul) if doubling \
            else G1.add_formula(a, a, mul)
    return G1.add_formula(a, b, mul)


def ec_double_add(G1, a, b, k: int):
    """2^k a + b on ((24, lanes),)*3 points, in one launch."""
    if _is_cpu(*a, *b):
        return ec_double_add_plain(G1, a, b, k)
    shape = _check_points("ec_double_add", a + b, 2)
    out = _empty_points(shape, a[0])
    rc = _launch(_build.lib().dt_ec_double_add, a[0],
                 *(_ptr(c) for c in a + b + out), k, shape[-1])
    ec_double_add.launches += 1
    _build.check(rc, "ec_double_add")
    return out


def ec_combine_plain(G1, g, c: int, doubling=True):
    """K8's plain version (windows MSB first): from T_0, per further window
    c doublings by DeviceG1.double_formula, then + T_w (the kernel's
    order).  doubling=False runs the JAX kernel's order: from the identity,
    per window c doublings as complete adds acc + acc, then + T_w; the same
    group element in another representative (compare in affine form)."""
    mul = G1.F.mul_plain
    windows, _, lanes = g[0].shape
    if not doubling:
        acc = G1.broadcast_identity((), lanes, g[0].device)
        for w in range(windows):
            for _ in range(c):
                acc = G1.add_formula(acc, acc, mul)
            acc = G1.add_formula(acc, tuple(t[w] for t in g), mul)
        return acc
    acc = tuple(t[0].clone() for t in g)
    for w in range(1, windows):
        for _ in range(c):
            acc = G1.double_formula(acc, mul)
        acc = G1.add_formula(acc, tuple(t[w] for t in g), mul)
    return acc


def ec_combine(G1, g, c: int):
    """g ((W, 24, lanes),)*3 window totals, MSB window first ->
    ((24, lanes),)*3 sum_w 2^(c (W-1-w)) T_w, in one launch (a team of six
    threads a lane); the CPU route runs the same order.  W >= 1."""
    if g[0].shape[0] < 1:
        raise ValueError("ec_combine: no windows")
    if _is_cpu(*g):
        return ec_combine_plain(G1, g, c)
    windows, _, lanes = _check_points("ec_combine", g, 3)
    out = _empty_points((24, lanes), g[0])
    rc = _launch(_build.lib().dt_ec_combine, g[0],
                 *(_ptr(t) for t in g + out), windows, c, lanes)
    ec_combine.launches += 1
    _build.check(rc, "ec_combine")
    return out


# -- K13: digit-product planes -> Fr Montgomery limbs ------------------------------------

PLANES = 65            # product planes of two 33-digit balanced numbers
RED_L = 17             # the reduction divides by R' = 2^(16 * 17)


@lru_cache(maxsize=None)
def _reduce_toeplitz(modulus: int, device: str):
    """float64 Toeplitz matrices of the K13 reduction's two constant
    products: (17, 17) for the low 17 columns of x * N'' (N'' = -p^-1 mod
    2^272) and (34, 17) for m * p."""
    npp = (-pow(modulus, -1, 1 << (16 * RED_L))) % (1 << (16 * RED_L))

    def limbs(v):
        return [(v >> (16 * i)) & MASK16 for i in range(RED_L)]

    lo = torch.zeros(RED_L, RED_L, dtype=torch.float64)
    mp = torch.zeros(2 * RED_L, RED_L, dtype=torch.float64)
    for j in range(RED_L):
        lo[j:, j] = torch.tensor(limbs(npp)[:RED_L - j], dtype=torch.float64)
        mp[j:j + RED_L, j] = torch.tensor(limbs(modulus), dtype=torch.float64)
    return lo.to(device), mp.to(device)


def reduce_planes_plain(F, planes):
    """K13's plain version, in int64: the signed carry sweep to 68 base-256
    digits, then the wide Montgomery reduction by 2^272 as two constant
    products (float64 Toeplitz matmuls, exact below 2^53) and one
    conditional subtraction (mxu_ntt.py::_reduce_kernel, step for step)."""
    p = planes.long()
    carry_ = torch.zeros_like(p[..., 0, :])
    digits = []
    for s in range(PLANES):
        v = p[..., s, :] + carry_
        digits.append(v & 0xFF)
        carry_ = v >> 8                          # arithmetic shift
    digits += [carry_ & 0xFF, (carry_ >> 8) & 0xFF, (carry_ >> 16) & 0xFF]
    d = torch.stack(digits, dim=-2)                            # (..., 68, N)
    t = d[..., 0::2, :] | (d[..., 1::2, :] << 8)               # (..., 34, N)
    lo, mp = _reduce_toeplitz(F.spec.modulus, str(planes.device))
    m = _normalize(torch.matmul(lo, t[..., :RED_L, :].double()).long())
    full = _normalize(t + torch.matmul(mp, m.double()).long())
    return F._cond_sub_mod(full[..., RED_L:RED_L + 16, :]).to(torch.int32)


def reduce_planes(F, planes):
    """(..., 65, N) int32 product planes -> (..., 16, N) canonical Fr
    Montgomery limbs, value (sum_s planes_s 2^(8s)) 2^-272 mod p; the total
    must be non-negative and below 2^272 p.  One launch for all leading
    rows."""
    if _is_cpu(planes):
        return reduce_planes_plain(F, planes)
    _check_int32(planes)
    if planes.dim() < 2 or planes.shape[-2] != PLANES or F.L != 16 \
            or not planes.is_contiguous():
        raise ValueError(f"reduce_planes: expected contiguous Fr (..., 65, "
                         f"N) planes, got {tuple(planes.shape)}")
    n = planes.shape[-1]
    out = torch.empty(planes.shape[:-2] + (16, n), dtype=torch.int32,
                      device=planes.device)
    rc = _launch(_build.lib().dt_reduce_planes, planes,
                 _ptr(planes), _ptr(out), math.prod(planes.shape[:-2]), n)
    reduce_planes.launches += 1
    _build.check(rc, "reduce_planes")
    return out


# -- K14: the round-3 quotient grid ------------------------------------------------------

# the columns of K14's constant table, csrc/quotient.cuh::QuotientColumn's
# order: the challenges, their products (alpha^2; each separator's kappa
# = sep^2 and its powers, as proving/widgets.py forms them), then the
# widget formulas' constants by value
QUOTIENT_TABLE = (
    "alpha", "beta", "gamma", "range_sep", "logic_sep", "fixed_base_sep",
    "var_base_sep", "alpha_sq",
    "range_kappa", "range_kappa_sq", "range_kappa_cu",
    "logic_kappa", "logic_kappa_sq", "logic_kappa_cu", "logic_kappa_qu",
    "fixed_kappa", "fixed_kappa_sq", "fixed_kappa_cu",
    "var_kappa", "var_kappa_sq",
    1, 2, 3, 4, 9, 18, 81, 83, JUBJUB_D, PERM_K1, PERM_K2, PERM_K3)


def quotient_consts(F, ch, device):
    """K14's constant table (QUOTIENT_TABLE) from the challenges' ints
    `ch`: alpha^2 and each separator's kappa = sep^2 and its powers,
    computed once on the host as proving/widgets.py forms them, and the
    formulas' constants, as one (16, C) Montgomery tensor."""
    from ..proving import widgets
    mul = widgets.HostOps.mul
    vals = dict(ch, alpha_sq=mul(ch["alpha"], ch["alpha"]))
    for fam, sep, top in (("range", "range_sep", 3), ("logic", "logic_sep", 4),
                          ("fixed", "fixed_base_sep", 3),
                          ("var", "var_base_sep", 2)):
        kappa = power = mul(ch[sep], ch[sep])
        for name in ("kappa", "kappa_sq", "kappa_cu", "kappa_qu")[:top]:
            vals[f"{fam}_{name}"] = power
            power = mul(power, kappa)
    spec = F.spec
    return F.pack([(vals[k] if isinstance(k, str) else k) * spec.mont_r
                   % spec.modulus for k in QUOTIENT_TABLE],
                  device, to_mont=False)


class _TableOps:
    """proving/widgets.py's backend for quotient_plain: LimbField's add and
    sub, the given multiply, and each constant of the formulas read from
    the table."""

    def __init__(self, F, mul, col):
        self.F, self._mul, self._col = F, mul, col

    def add(self, a, b):
        return self.F.add(a, b)

    def sub(self, a, b):
        return self.F.sub(a, b)

    def mul(self, a, b):
        return self._mul(a, b)

    def scalar(self, v):
        return self._col[v]


def quotient_plain(F, evs, halo, sel8, sig8, l1_8, lin8, vh_inv8, consts,
                   mul=None):
    """K14's plain version: the widget chain of proving/widgets.py over
    limb tensors, formula for formula, the next gate (i + 8) as a copy of
    each row's columns past the eighth and the halo's eight, and every
    challenge and constant from the table.  `mul` is the chain's
    multiply (default K1's plain version, F.mul_plain; chip_smoke passes
    F.mul, K1, to run the chain at full width)."""
    from ..proving import widgets
    from ..proving.keys import SELECTOR_NAMES
    ch = {key: consts[:, j:j + 1] for j, key in enumerate(QUOTIENT_TABLE)}
    ops = _TableOps(F, mul or F.mul_plain, ch)
    z8, a8, b8, c8, d8, pi8 = evs
    z_n, a_n, b_n, d_n = torch.cat([evs[[0, 1, 2, 4], :, 8:], halo], dim=-1)
    s = dict(zip(SELECTOR_NAMES, sel8))

    t = widgets.arithmetic_quotient(
        ops, s["q_m"], s["q_l"], s["q_r"], s["q_o"], s["q_c"],
        s["q_4"], s["q_arith"], a8, b8, c8, d8)
    t = F.add(t, pi8)
    t = F.add(t, widgets.range_quotient(
        ops, s["q_range"], ch["range_sep"], a8, b8, c8, d8, d_n))
    t = F.add(t, widgets.logic_quotient(
        ops, s["q_logic"], s["q_c"], ch["logic_sep"],
        a8, a_n, b8, b_n, c8, d8, d_n))
    t = F.add(t, widgets.fixed_base_quotient(
        ops, s["q_fixed_group_add"], s["q_l"], s["q_r"], s["q_c"],
        ch["fixed_base_sep"], a8, a_n, b8, b_n, c8, d8, d_n))
    t = F.add(t, widgets.variable_base_quotient(
        ops, s["q_variable_group_add"], ch["var_base_sep"],
        a8, a_n, b8, b_n, c8, d8, d_n))
    l1_alpha_sq = ops.mul(l1_8, ch["alpha_sq"])
    t = F.add(t, widgets.permutation_quotient(
        ops, lin8, sig8[0], sig8[1], sig8[2], sig8[3], a8, b8, c8, d8,
        z8, z_n, ch["alpha"], l1_alpha_sq, ch["beta"], ch["gamma"]))
    return ops.mul(t, vh_inv8)


def _check_quotient(F, evs, halo, sel8, sig8, l1_8, lin8, vh_inv8, consts):
    E = evs.shape[-1]
    want = {"evs": (6, 16, E), "halo": (4, 16, 8), "sel8": (11, 16, E),
            "sig8": (4, 16, E), "l1_8": (16, E), "lin8": (16, E),
            "vh_inv8": (16, E), "consts": (16, len(QUOTIENT_TABLE))}
    got = dict(zip(want, (evs, halo, sel8, sig8, l1_8, lin8, vh_inv8,
                          consts)))
    _check_int32(*got.values())
    bad = {k: tuple(t.shape) for k, t in got.items()
           if tuple(t.shape) != want[k] or not t.is_contiguous()}
    if F.L != 16 or E < 8 or bad:
        raise ValueError(f"quotient: expected contiguous Fr {want} with "
                         f"E >= 8, got {bad or E}")


def quotient(F, evs, halo, sel8, sig8, l1_8, lin8, vh_inv8, consts):
    """The quotient grid t(X) / Z_H(X) over E points of the 8n coset (or
    one shard of it) -> (16, E) Montgomery limbs, one launch.  evs (6, 16,
    E): the coset evaluations of z, a, b, c, d, pi; halo (4, 16, 8): z, a,
    b, d at the 8 points after the last (on one device the first 8 of the
    coset, on a shard M.next_halo's); sel8 (11, 16, E), sig8 (4, 16, E),
    l1_8, lin8, vh_inv8 (16, E): the key's tables over those points;
    consts (16, C): QUOTIENT_TABLE in Montgomery form."""
    args = (evs, halo, sel8, sig8, l1_8, lin8, vh_inv8, consts)
    _check_quotient(F, *args)
    if _is_cpu(*args):
        return quotient_plain(F, *args)
    E = evs.shape[-1]
    out = torch.empty((16, E), dtype=torch.int32, device=evs.device)
    rc = _launch(_build.lib().dt_quotient, out, *(_ptr(t) for t in args),
                 _ptr(out), E, consts.shape[-1])
    quotient.launches += 1
    _build.check(rc, "quotient")
    return out


# -- K15: the wire gather ------------------------------------------------------------

def wire_gather_plain(F, table, cols):
    """K15's plain version: rows of the witness table indexed by cols in
    torch, split into 16-bit limbs, then K1's plain multiply by R^2."""
    words = table[cols.long()]                               # (W, n, 8)
    limbs = torch.stack([words & MASK16, (words >> 16) & MASK16], dim=-1)
    canon = limbs.reshape(cols.shape + (16,)).movedim(-1, -2)
    return mont_mul_plain(F, canon, F.const("r2", table.device)).contiguous()


def wire_gather(F, table, cols):
    """A proof's wire columns -> (W, 16, n) Fr Montgomery limbs, one
    launch.  table (rows, 8) int32: each row a canonical witness value's
    eight 32-bit words, least significant first; cols (W, n) int32: the
    row of each (wire, point), every one in [0, rows)."""
    _check_int32(table, cols)
    if F.L != 16 or table.dim() != 2 or table.shape[-1] != 8 \
            or cols.dim() != 2 or not table.is_contiguous() \
            or not cols.is_contiguous():
        raise ValueError(f"wire_gather: expected contiguous Fr (rows, 8) "
                         f"and (W, n), got {tuple(table.shape)} and "
                         f"{tuple(cols.shape)}")
    if _is_cpu(table, cols):
        return wire_gather_plain(F, table, cols)
    W, n = cols.shape
    out = torch.empty((W, 16, n), dtype=torch.int32, device=cols.device)
    rc = _launch(_build.lib().dt_wire_gather, out, _ptr(table), _ptr(cols),
                 _ptr(out), W, n)
    wire_gather.launches += 1
    _build.check(rc, "wire_gather")
    return out


reset_launches()
