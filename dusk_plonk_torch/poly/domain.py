"""Host evaluation domain (radix-2) over Fr — the exactness oracle for the
device NTT in ops/ntt.py.

Mirrors the API surface the reference consumes from poly-commit's `Fft`
(usage: reference src/prover.rs:88,121-124; src/key.rs:83,216-245;
src/prover/quotient_poly.rs:50-58,115):
  new(k), dft, idft, coset_dft, coset_idft, elements, size/size_inv,
  generator/generator_inv, compute_vanishing_poly_over_coset.

The coset is g*H with g = 7 (the multiplicative generator of Fr, the
standard coset shift in the dusk/zkcrypto stack).
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.constants import R_MOD, FR_GENERATOR
from ..fields.host import fr_root_of_unity


def _bit_reverse_permute(a: list) -> list:
    n = len(a)
    bits = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        j = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
        out[j] = a[i]
    return out


def _fft_in_place(a: list, root: int) -> list:
    """Iterative radix-2 Cooley-Tukey; `a` in natural order, returns natural
    order evaluations at powers of `root`."""
    n = len(a)
    if n == 1:
        return list(a)
    a = _bit_reverse_permute(a)
    log_n = n.bit_length() - 1
    # stage twiddles
    for s in range(1, log_n + 1):
        m = 1 << s
        w_m = pow(root, n // m, R_MOD)
        for k in range(0, n, m):
            w = 1
            for j in range(m // 2):
                t = w * a[k + j + m // 2] % R_MOD
                u = a[k + j]
                a[k + j] = (u + t) % R_MOD
                a[k + j + m // 2] = (u - t) % R_MOD
                w = w * w_m % R_MOD
    return a


class Domain:
    """Radix-2 evaluation domain of size 2^k."""

    def __init__(self, k: int):
        self.k = k
        self.size = 1 << k
        self.generator = fr_root_of_unity(k)          # Fft::generator()
        self.generator_inv = pow(self.generator, -1, R_MOD)
        self.size_inv = pow(self.size, -1, R_MOD)
        self.coset_shift = FR_GENERATOR
        self.coset_shift_inv = pow(FR_GENERATOR, -1, R_MOD)

    @property
    def elements(self) -> list[int]:
        """Domain roots in natural order [1, w, w^2, ...]
        (Fft::elements, usage reference src/permutation.rs:148,246)."""
        return self._elements()

    @lru_cache(maxsize=None)
    def _elements(self):
        out = [1] * self.size
        for i in range(1, self.size):
            out[i] = out[i - 1] * self.generator % R_MOD
        return out

    def dft(self, coeffs: list[int]) -> list[int]:
        a = list(coeffs[: self.size])
        a += [0] * (self.size - len(a))
        if _native is not None:
            return _native.fr_ntt(a, self.generator)
        return _fft_in_place(a, self.generator)

    def idft(self, evals: list[int]) -> list[int]:
        a = list(evals[: self.size])
        a += [0] * (self.size - len(a))
        if _native is not None:
            a = _native.fr_ntt(a, self.generator_inv)
            return _native.fr_scale_geo(a, self.size_inv, 1)
        a = _fft_in_place(a, self.generator_inv)
        return [x * self.size_inv % R_MOD for x in a]

    def coset_dft(self, coeffs: list[int]) -> list[int]:
        """Evaluate over the coset g*H: scale coeff i by g^i, then DFT."""
        a = list(coeffs[: self.size])
        a += [0] * (self.size - len(a))
        if _native is not None:
            return _native.fr_ntt(
                _native.fr_scale_geo(a, 1, self.coset_shift),
                self.generator)
        g = 1
        scaled = []
        for c in a:
            scaled.append(c * g % R_MOD)
            g = g * self.coset_shift % R_MOD
        return _fft_in_place(scaled, self.generator)

    def coset_idft(self, evals: list[int]) -> list[int]:
        a = self.idft(evals)
        if _native is not None:
            return _native.fr_scale_geo(a, 1, self.coset_shift_inv)
        g = 1
        out = []
        for c in a:
            out.append(c * g % R_MOD)
            g = g * self.coset_shift_inv % R_MOD
        return out

    def compute_vanishing_poly_over_coset(self, zeroing_degree: int) -> list[int]:
        """Evaluations of X^n - 1 (n = zeroing_degree) over this domain's
        coset (reference usage src/key.rs:291)."""
        g_n = pow(self.coset_shift, zeroing_degree, R_MOD)
        w_n = pow(self.generator, zeroing_degree, R_MOD)
        out = []
        acc = g_n
        for _ in range(self.size):
            out.append((acc - 1) % R_MOD)
            acc = acc * w_n % R_MOD
        return out


try:
    from .. import native as _native
    if not _native.available():
        _native = None
except Exception:  # pragma: no cover
    _native = None
