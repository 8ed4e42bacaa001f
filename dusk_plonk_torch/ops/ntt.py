"""Radix-2 NTT over Fr limb tensors.

Counterpart of dusk_plonk_tpu/ops/ntt.py: iterative Cooley-Tukey on
(..., 16, n) Montgomery limbs, bit reversal as one gather, then the k
butterfly stages of kernel K2 (ops/kernels.py::ntt_ladder).  One transform
serves dft / idft / coset_dft / coset_idft: direction and coset live in the
VALUES of the twiddle table and of the pre/post scales.

The stage twiddles come from one (16, n/2) table of powers of the stage
root (stage s reads entry (j mod 2^s) << (k-1-s)), where the JAX package
stacked a (k, 16, n) table per direction to fit the TPU's dynamic slicing.

With `config.ntt_mxu_min_k` set, domains 2^k with k >= it (and
`mxu_ntt.supported(k)`) take the four-step transform of ops/mxu_ntt.py
instead (int8 tensor-core products, kernel K13), as
dusk_plonk_tpu/ops/ntt.py:88-101 routes them; the tables then hold digit
planes and the ladder's tables are not built.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.constants import R_MOD, FR_GENERATOR
from ..fields.host import fr_root_of_unity
from ..utils.config import get_config
from . import kernels, mxu_ntt
from .limb import fr_field


def _bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for _ in range(bits):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out


class NttPlan:
    """All tables for one domain size 2^k, on one device."""

    def __init__(self, k: int, device):
        self.k = k
        self.n = n = 1 << k
        F = self.F = fr_field()
        w = fr_root_of_unity(k)
        w_inv = pow(w, -1, R_MOD)
        n_inv = pow(n, -1, R_MOD)
        g = FR_GENERATOR
        g_inv = pow(g, -1, R_MOD)

        min_k = get_config().ntt_mxu_min_k
        self.mxu = min_k is not None and k >= min_k and mxu_ntt.supported(k)
        if self.mxu:
            self.tw_fwd = mxu_ntt.MxuNttTables(F, k, w, device)
            self.tw_inv = mxu_ntt.MxuNttTables(F, k, w_inv, device)
        else:
            self.bitrev = torch.from_numpy(_bitrev_indices(n)).to(device)
            half = max(n // 2, 1)
            self.tw_fwd = F.powers_host_base(w, half, device)   # (16, n/2)
            self.tw_inv = F.powers_host_base(w_inv, half, device)
        # constant scales stay (16, 1) broadcasts
        self.scale_one = F.pack([1], device)
        self.scale_n_inv = F.pack([n_inv], device)
        self.scale_coset = F.powers_host_base(g, n, device)
        # coset_idft: iNTT, then multiply by g^-i with 1/n folded in
        self.scale_coset_inv = F.powers_host_base(g_inv, n, device,
                                                  scale=n_inv)

    def _transform(self, data, twiddles, pre_scale, post_scale):
        """data (..., 16, n) Montgomery -> (..., 16, n)."""
        F = self.F
        if self.mxu:
            return mxu_ntt.four_step(F, self.k, data, twiddles, pre_scale,
                                     post_scale)
        x = F.mul(data, pre_scale)
        x = x.index_select(-1, self.bitrev)
        if self.k > 0:
            x = kernels.ntt_ladder(F, x, twiddles, self.k)
        return F.mul(x, post_scale)

    def dft(self, coeffs):
        return self._transform(coeffs, self.tw_fwd, self.scale_one,
                               self.scale_one)

    def idft(self, evals):
        return self._transform(evals, self.tw_inv, self.scale_one,
                               self.scale_n_inv)

    def coset_dft(self, coeffs):
        return self._transform(coeffs, self.tw_fwd, self.scale_coset,
                               self.scale_one)

    def coset_idft(self, evals):
        return self._transform(evals, self.tw_inv, self.scale_one,
                               self.scale_coset_inv)
