"""NTT over Fr limb tensors.

Counterpart of dusk_plonk_tpu/ops/ntt.py: the DFT of (..., 16, n)
Montgomery limbs along the element axis, natural order in and out.  One
transform serves dft / idft / coset_dft / coset_idft: direction and coset
live in the VALUES of the tables and of the pre / post scales.

The transform is kernel K2 (ops/kernels.py::ntt): 1-3 passes of the
Bailey split (kernels.ntt_passes), each running all its radix-2 levels in
shared memory, with the coset pre-scale folded into the first pass's load
and the 1/n or g^-i/n post-scale into the last pass's store (a scale of
one is no multiply).  The tables each pass needs are built here once, on
the device, packed 8 words an element: the in-tile roots w_m^e (e < m/2)
and the mid twiddle w_N^(b c) (N entries) of every pass but the last, per
direction.

With `config.ntt_mxu_min_k` set, domains 2^k with k >= it (and
`mxu_ntt.supported(k)`) take the four-step transform of ops/mxu_ntt.py
instead (int8 tensor-core products, kernel K13), as
dusk_plonk_tpu/ops/ntt.py:88-101 routes them; the tables then hold digit
planes and K2's tables are not built.

`ladder_oracle` is the radix-2 ladder of earlier versions (scale, bit
reversal, k stages, scale), for tests and chip_smoke.py only.
"""

from __future__ import annotations

import torch

from ..fields.constants import R_MOD, FR_GENERATOR
from ..fields.host import fr_root_of_unity
from ..utils.config import get_config
from . import kernels, mxu_ntt
from .limb import fr_field


class NttPlan:
    """All tables for one domain size 2^k, on one device.  `passes`
    forces K2's pass count (tests)."""

    def __init__(self, k: int, device, passes=None):
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
            # constant scales stay (16, 1) broadcasts
            self.scale_one = F.pack([1], device)
            self.scale_n_inv = F.pack([n_inv], device)
            self.scale_coset = F.powers_host_base(g, n, device)
            self.scale_coset_inv = F.powers_host_base(g_inv, n, device,
                                                      scale=n_inv)
            return
        self.passes = kernels.ntt_passes(k, passes)
        self.steps_fwd = self._steps(w, device)
        self.steps_inv = self._steps(w_inv, device)
        pack = kernels.pack_words
        self.scale_n_inv = pack(F.pack([n_inv], device))          # (1, 8)
        self.scale_coset = pack(F.powers_host_base(g, n, device))  # (n, 8)
        # coset_idft: iNTT, then multiply by g^-i with 1/n folded in
        self.scale_coset_inv = pack(F.powers_host_base(g_inv, n, device,
                                                       scale=n_inv))

    def _steps(self, root: int, device):
        """((NttPass, roots (m/2, 8), mid (N, 8) or None),) for the n-th
        root `root`: pass p's in-tile roots are powers of root^(n/m), its
        mid twiddle table holds root^((n/N) b c) at c D + b."""
        F, n = self.F, self.n
        steps = []
        for p in self.passes:
            m = 1 << p.log_m
            roots = F.powers_host_base(pow(root, n // m, R_MOD),
                                       max(m // 2, 1), device)
            mid = None
            if p.mid:
                N = p.mid
                pw = F.powers_host_base(pow(root, n // N, R_MOD), N, device)
                e = torch.arange(N, device=device)
                mid = kernels.pack_words(pw[:, (e // p.D) * (e % p.D) % N])
            steps.append((p, kernels.pack_words(roots), mid))
        return tuple(steps)

    def _transform(self, data, steps, pre_scale, post_scale):
        """data (..., 16, n) Montgomery -> (..., 16, n); a scale of None
        is one."""
        if self.mxu:
            one = self.scale_one
            return mxu_ntt.four_step(
                self.F, self.k, data, steps,
                one if pre_scale is None else pre_scale,
                one if post_scale is None else post_scale)
        return kernels.ntt(self.F, data, self.k, steps, pre_scale,
                           post_scale)

    def _tables(self, inverse: bool):
        if self.mxu:
            return self.tw_inv if inverse else self.tw_fwd
        return self.steps_inv if inverse else self.steps_fwd

    def dft(self, coeffs):
        return self._transform(coeffs, self._tables(False), None, None)

    def idft(self, evals):
        return self._transform(evals, self._tables(True), None,
                               self.scale_n_inv)

    def coset_dft(self, coeffs):
        return self._transform(coeffs, self._tables(False),
                               self.scale_coset, None)

    def coset_idft(self, evals):
        return self._transform(evals, self._tables(True), None,
                               self.scale_coset_inv)


def ladder_oracle(F, k: int, kind: str, x):
    """The transform as earlier versions composed it, for tests and
    chip_smoke.py: pre-scale (K1's plain version, a multiply by one
    included), bit reversal by index_select, the k stages of
    kernels.ntt_ladder_plain on the (16, n/2) stage-root powers, post-scale.
    Runs on any device; only its tables are built with K1 on the card."""
    n = 1 << k
    w = fr_root_of_unity(k)
    inverse = kind in ("idft", "coset_idft")
    root = pow(w, -1, R_MOD) if inverse else w
    n_inv = pow(n, -1, R_MOD)
    dev = x.device
    one = F.const("one_mont", dev)
    g_inv = pow(FR_GENERATOR, -1, R_MOD)
    pre = F.powers_host_base(FR_GENERATOR, n, dev) \
        if kind == "coset_dft" else one
    if kind == "idft":
        post = F.pack([n_inv], dev)
    elif kind == "coset_idft":
        post = F.powers_host_base(g_inv, n, dev, scale=n_inv)
    else:
        post = one
    x = F.mul_plain(x, pre).index_select(
        -1, kernels.bitrev_indices(k, str(dev)))
    if k > 0:
        tw = F.powers_host_base(root, max(n // 2, 1), dev)
        x = kernels.ntt_ladder_plain(F, x, tw, k)
    return F.mul_plain(x, post)
