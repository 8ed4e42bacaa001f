"""Four-step NTT with the DFT matrix products as int8 digit-plane GEMMs.

Counterpart of dusk_plonk_tpu/ops/mxu_ntt.py (whose products ran on the
TPU's matrix unit, the MXU; the name is kept so a reader finds it).  On
Hopper the int8 products run on the tensor cores: `torch._int_mm`, int8 x
int8 -> int32 through cuBLASLt, a plain matrix product that the JAX package
also left to its compiler (`jnp.einsum`, outside any Pallas kernel).

  n = n1 n2, j = j2 n1 + j1, k = k1 n2 + k2 (Bailey four-step):
    Y[k1 n2 + k2] = sum_{j1} w_n1^{j1 k1} ( w_n^{j1 k2}
                    sum_{j2} w_n2^{j2 k2} x[j2 n1 + j1] )
  i.e. an (n2, n1) grid, the n2-point DFT matrix on the left, an
  elementwise twiddle, a transpose, the n1-point DFT matrix.

Each modular matrix product splits both operands into 33 BALANCED base-256
digit planes (digits in [-128, 127]: exact int8 products), accumulates the
65 int32 product planes P_s = sum_{l + l' = s} W_l' X_l, and reduces them
with kernel K13 (ops/kernels.py::reduce_planes): one Montgomery reduction
by R' = 2^272 gives Mont(w x) 2^-16; the two 2^-16 residues fold into the
mid twiddle (stored as Mont(w^{j1 k2} 2^32)), so the pre / post scales are
the butterfly ladder's.  |P| <= 33 mi 2^14 stays below 2^31 for a
contraction mi <= 2^11, which `supported(k)` checks.

The structure is the JAX package's: 33 GEMMs a matrix step, each adding its
33 output planes into the 65-plane accumulator.  cuBLASLt's int8 product
wants a contraction and an output width that are multiples of 8 (and more
than 16 rows, which 33 mo always is): `_int8_mm` pads both with zero digit
rows and columns where the shape is not, so `supported` needs no extra
gate; at the prover's domains (2^16, 2^19) nothing is padded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.constants import R_MOD
from . import kernels
from .kernels import resolve_carries
from .limb import FR_SPEC

D_DIG = 33                  # balanced base-256 digits of a value < 2^256
MAX_CONTRACT = 1 << 11      # |P| <= 33 mi 2^14 must stay < 2^31


def split(k: int) -> tuple[int, int]:
    """(n1, n2) of the 2^k domain: n1 = 2^ceil(k/2), n2 = n / n1."""
    n1 = 1 << ((k + 1) // 2)
    return n1, (1 << k) // n1


def supported(k: int) -> bool:
    """True if the 2^k domain fits the int32 plane-accumulator bound."""
    return 2 <= split(k)[0] <= MAX_CONTRACT


# -- host digit tables ---------------------------------------------------------

def _balanced_digits_host(vals) -> np.ndarray:
    """Ints in [0, 2^256) -> (33, n) int8 balanced base-256 digits:
    digit_i = byte_i(v + H) - 128, H = 0x8080..80 (32 bytes), and the
    carry-out as digit 32."""
    H = int.from_bytes(b"\x80" * 32, "little")
    buf = b"".join((int(v) + H).to_bytes(33, "little") for v in vals)
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(len(vals), 33)
    out = raw.astype(np.int16)
    out[:, :32] -= 128
    return out.astype(np.int8).T.copy()


def _dft_matrix_digits(m: int, base: int) -> np.ndarray:
    """(33, m, m) int8 digit planes of Mont(base^(i j) mod p), the m-point
    DFT matrix in Montgomery form."""
    R = FR_SPEC.mont_r
    pows = [1] * m
    for i in range(1, m):
        pows[i] = pows[i - 1] * base % R_MOD
    dig = _balanced_digits_host([v * R % R_MOD for v in pows])
    idx = np.outer(np.arange(m), np.arange(m)) % m
    return dig[:, idx]


# -- device digits and the modular matrix product ---------------------------------

def _to_digits(x):
    """(..., 16, N) int32 Montgomery limbs -> (..., 33, N) int8 balanced
    digits: bytes(x + 0x8080..80) - 128, the carry-out as digit 32."""
    y, cout = resolve_carries(x + 0x8080)
    lo = (y & 0xFF) - 128
    hi = (y >> 8) - 128
    d32 = torch.stack([lo, hi], dim=-2).reshape(
        x.shape[:-2] + (32, x.shape[-1]))
    return torch.cat([d32, cout.unsqueeze(-2).to(d32.dtype)],
                     dim=-2).to(torch.int8)


def _int8_mm(a, b):
    """a (m, kk) int8 @ b (kk, w) int8 -> (m, w) int32 by torch._int_mm,
    the contraction and the width zero-padded to multiples of 8."""
    kk, w = b.shape
    pk, pw = -kk % 8, -w % 8
    if pk:
        a = torch.nn.functional.pad(a, (0, pk))
    if pk or pw:
        b = torch.nn.functional.pad(b, (0, pw, 0, pk))
    out = torch._int_mm(a, b)
    return out[:, :w] if pw else out


def int8_products(wd, xd):
    """The digit-plane products of one modular matrix product: wd (33,
    mo, mi) and xd (B, 33, mi, t) int8 -> the (B, 65, mo, t) int32 planes
    P_s = sum_{l + l' = s} W_l' X_l, as 33 GEMMs of (33 mo, mi) x
    (mi, B t)."""
    B, _, mi, t = xd.shape
    mo = wd.shape[1]
    a = wd.reshape(D_DIG * mo, mi)
    cols = xd.permute(1, 2, 0, 3).reshape(D_DIG, mi, B * t)
    planes = torch.zeros((B, kernels.PLANES, mo, t), dtype=torch.int32,
                         device=xd.device)
    for l in range(D_DIG):
        q = _int8_mm(a, cols[l]).reshape(D_DIG, mo, B, t)
        planes[:, l:l + D_DIG] += q.permute(2, 0, 1, 3)
    return planes


def mod_matmul(F, wd, x):
    """wd (33, mo, mi) int8 digit planes of a Montgomery-form constant
    matrix; x (..., 16, mi, t) Montgomery limbs -> (..., 16, mo, t) =
    Mont(W @ X) 2^-16 (the R'-reduction residue, folded by the caller)."""
    lead = x.shape[:-3]
    mi, t = x.shape[-2:]
    mo = wd.shape[1]
    xd = _to_digits(x.reshape(lead + (16, mi * t)))
    planes = int8_products(wd, xd.reshape(-1, D_DIG, mi, t))
    out = kernels.reduce_planes(F, planes.reshape(-1, kernels.PLANES,
                                                  mo * t))
    return out.reshape(lead + (16, mo, t))


# -- the four-step transform ----------------------------------------------------------

class MxuNttTables:
    """One direction's tables on one device: the two DFT matrices' digit
    planes and the mid twiddle."""

    def __init__(self, F, k: int, base: int, device):
        n1, n2 = split(k)
        n = n1 * n2
        # step 1 contracts j2 (n2-point root), step 2 j1 (n1-point root)
        self.w2d = torch.from_numpy(
            _dft_matrix_digits(n2, pow(base, n1, R_MOD))).to(device)
        self.w1d = torch.from_numpy(
            _dft_matrix_digits(n1, pow(base, n2, R_MOD))).to(device)
        # Mont(base^(j1 k2) 2^32): cancels the two 2^-16 residues
        full = F.powers_host_base(base, n, device, scale=(1 << 32) % R_MOD)
        idx = (np.outer(np.arange(n2), np.arange(n1)) % n).reshape(-1)
        self.mid = full.index_select(1, torch.from_numpy(idx).to(device))


def four_step(F, k: int, x, tables: MxuNttTables, pre_scale, post_scale):
    """x (..., 16, n) Montgomery -> its DFT along the element axis, natural
    order in and out."""
    n1, n2 = split(k)
    lead = x.shape[:-2]
    x = F.mul(x, pre_scale)
    g = mod_matmul(F, tables.w2d, x.reshape(lead + (16, n2, n1)))
    g = F.mul(g.reshape(lead + (16, n1 * n2)), tables.mid)
    g = g.reshape(lead + (16, n2, n1)).transpose(-1, -2)
    g = mod_matmul(F, tables.w1d, g)                       # k1 major
    return F.mul(g.reshape(lead + (16, n1 * n2)), post_scale)
