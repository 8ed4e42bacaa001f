"""Fixed-limb Montgomery field arithmetic on torch tensors.

Counterpart of dusk_plonk_tpu/ops/limb.py.  A field element is L 16-bit
limbs (Fr: L = 16, R = 2^256; Fq: L = 24, R = 2^384) in a LIMB-MAJOR
(..., L, N) tensor, element axis minormost, exactly the values and layout of
the JAX package's arrays.  Storage is int32, not uint32: CPU torch has no
uint32 add, shift or compare, and 16-bit values fit int32 with room for the
lazy sums below.  Scalars are (L, 1) and broadcast against any (..., L, N).

Multiplication is kernel K1 (ops/kernels.py::mont_mul): the CUDA kernel on
a CUDA tensor, its plain int64 version on a CPU tensor.  Add, sub and the
carry chains stay plain torch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import kernels
from .kernels import MASK16, carry, resolve_carries


@dataclass(frozen=True)
class FieldSpec:
    """Static parameters of one field's limb representation."""
    name: str
    modulus: int
    limbs: int

    @property
    def bits(self) -> int:
        return self.limbs * 16

    @property
    def mont_r(self) -> int:
        return (1 << self.bits) % self.modulus

    @property
    def mont_r2(self) -> int:
        return pow(self.mont_r, 2, self.modulus)


def int_to_limbs(spec: FieldSpec, x: int) -> np.ndarray:
    """Python int -> (L,) int32 array of 16-bit limbs, least significant
    first."""
    return np.frombuffer(int(x).to_bytes(spec.limbs * 2, "little"),
                         dtype="<u2").astype(np.int32)


class LimbField:
    """Torch ops for one field, batched over the element (last) axis and
    any leading axes.  Every method takes tensors on one device and returns
    tensors on that device."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.L = spec.limbs
        nprime = (-pow(spec.modulus, -1, 1 << spec.bits)) % (1 << spec.bits)
        one = np.zeros(self.L, np.int32)
        one[0] = 1
        self._np = {
            "mod": int_to_limbs(spec, spec.modulus),
            "r2": int_to_limbs(spec, spec.mont_r2),
            "one_mont": int_to_limbs(spec, spec.mont_r),
            "nprime": int_to_limbs(spec, nprime),
            "one": one,
        }
        self._dev: dict = {}

    def toeplitz(self, name: str, device) -> torch.Tensor:
        """(2L+1, L) float64 matrix T[k, j] = c[k - j] of the constant
        `name`: T @ x gives the product columns of c times x."""
        key = ("toeplitz", name, str(device))
        t = self._dev.get(key)
        if t is None:
            c = self._np[name]
            L = self.L
            m = np.zeros((2 * L + 1, L))
            for j in range(L):
                m[j:j + L, j] = c
            t = torch.from_numpy(m).to(device)
            self._dev[key] = t
        return t

    def const(self, name: str, device) -> torch.Tensor:
        """(L, 1) int32 constant on `device`: mod, r2, one_mont, nprime or
        one (canonical 1)."""
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(self._np[name][:, None].copy()).to(device)
            self._dev[key] = t
        return t

    # -- host <-> device ---------------------------------------------------------

    def pack_host(self, values) -> np.ndarray:
        """Python ints -> (L, N) int32 numpy limbs (canonical, no
        Montgomery)."""
        buf = b"".join(int(v).to_bytes(self.L * 2, "little") for v in values)
        arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), self.L)
        return np.ascontiguousarray(arr.T).astype(np.int32)

    def pack(self, values, device, to_mont: bool = True, shape=None):
        """Python ints -> (L, N) limbs on `device` (Montgomery by default).
        With `shape`, returns shape[:-1] + (L, shape[-1])."""
        out = torch.from_numpy(self.pack_host(values)).to(device)
        if to_mont:
            out = self.mul(out, self.const("r2", device))
        if shape is not None:
            out = out.reshape((self.L,) + tuple(shape)).movedim(0, -2)
        return out.contiguous()

    def pack_scalar(self, value: int, device, to_mont: bool = True):
        return self.pack([value], device, to_mont)

    def pack_sparse(self, pairs, n: int, device, to_mont: bool = True):
        """[(index, value)], distinct indexes -> (L, n) limbs on `device`,
        zeros elsewhere: a device fill, then one index-put from one tensor
        of the pairs; the Montgomery conversion runs on the host per
        entry."""
        out = torch.zeros((self.L, n), dtype=torch.int32, device=device)
        if pairs:
            spec = self.spec
            rows = np.array([[i] + list(int_to_limbs(
                spec, v * spec.mont_r % spec.modulus if to_mont else v))
                for i, v in pairs], np.int64)                # (P, 1 + L)
            t = torch.from_numpy(rows).to(device)
            out[:, t[:, 0]] = t[:, 1:].T.to(torch.int32)
        return out

    def unpack(self, arr, from_mont: bool = True) -> list[int]:
        """(..., L, N) limbs -> flat list of canonical Python ints."""
        if from_mont:
            arr = self.from_mont(arr)
        host = arr.cpu().numpy().astype("<u2")
        flat = np.moveaxis(host, -2, -1).reshape(-1, self.L)
        return [int.from_bytes(row.tobytes(), "little") for row in flat]

    # -- add / sub (plain torch) --------------------------------------------------

    def _sub_borrow(self, a, b):
        """a - b of carried limbs via a + ~b + 1 -> (diff, borrow_out)."""
        s = a + (b ^ MASK16)
        s[..., 0, :] += 1
        diff, carry_out = resolve_carries(s)
        return diff, ~carry_out

    def _cond_sub_mod(self, a):
        """a - p if a >= p (expects a < 2p, carried)."""
        diff, borrow = self._sub_borrow(a, self.const("mod", a.device))
        return torch.where(borrow[..., None, :], a, diff)

    def add(self, a, b):
        return self._cond_sub_mod(carry(a + b))

    def sub(self, a, b):
        d, borrow = self._sub_borrow(a, b)
        wrapped = carry(d + self.const("mod", d.device))
        return torch.where(borrow[..., None, :], wrapped, d)

    def neg(self, a):
        is_zero = (a == 0).all(dim=-2, keepdim=True)
        n, _ = self._sub_borrow(self.const("mod", a.device).expand_as(a), a)
        return torch.where(is_zero, torch.zeros_like(a), n)

    def select(self, cond, a, b):
        """Elementwise select: cond (..., N) bool -> a or b."""
        return torch.where(cond[..., None, :], a, b)

    # -- multiply (kernel K1) ---------------------------------------------------------

    def mul(self, a, b):
        """Montgomery a * b * R^-1, canonical; broadcasts like `a * b`."""
        return kernels.mont_mul(self, a, b)

    def mul_plain(self, a, b):
        """K1's plain PyTorch version on any device (never a kernel)."""
        return kernels.mont_mul_plain(self, a, b)

    def from_mont(self, a):
        """Montgomery -> canonical limbs (multiply by canonical 1)."""
        return self.mul(a, self.const("one", a.device))

    def pow_const(self, a, exponent: int):
        """a^e for a Python-int exponent (square-and-multiply, MSB first)."""
        e = int(exponent)
        if e == 0:
            return self.const("one_mont", a.device).expand_as(a).contiguous()
        acc = a
        for bit in bin(e)[3:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inverse a^(p-2); zero stays zero (use batch_inv for
        arrays)."""
        return self.pow_const(a, self.spec.modulus - 2)

    def prefix_mul(self, x):
        """Inclusive prefix product along the element axis (Hillis-Steele:
        log2(n) rounds of one mul each)."""
        n = x.shape[-1]
        idx = torch.arange(n, device=x.device)
        for i in range((n - 1).bit_length()):
            sh = 1 << i
            prod = self.mul(x, torch.roll(x, sh, dims=-1))
            x = torch.where(idx >= sh, prod, x)
        return x

    def batch_inv(self, a):
        """Montgomery's trick over the element axis: one Fermat inverse and
        3N multiplications.  Zero entries map to zero."""
        one = self.const("one_mont", a.device)
        is_zero = (a == 0).all(dim=-2, keepdim=True)
        safe = torch.where(is_zero, one, a)
        prefix = self.prefix_mul(safe)
        suffix = self.prefix_mul(safe.flip(-1)).flip(-1)
        total_inv = self.inv(prefix[..., -1:])
        ones = one.expand(safe[..., :1].shape)
        prefix_excl = torch.cat([ones, prefix[..., :-1]], dim=-1)
        suffix_excl = torch.cat([suffix[..., 1:], ones], dim=-1)
        out = self.mul(self.mul(prefix_excl, suffix_excl), total_inv)
        return torch.where(is_zero, torch.zeros_like(a), out)

    def powers(self, base, n: int):
        """[1, base, ..., base^(n-1)] as (L, n) for a device (L, 1) base:
        square-and-multiply over the bits of the index."""
        idx = torch.arange(n, device=base.device)
        out = self.const("one_mont", base.device).expand(self.L, n)
        sq = base
        for b in range(max(1, (n - 1).bit_length())):
            bit = ((idx >> b) & 1) == 1
            out = torch.where(bit, self.mul(out, sq), out)
            sq = self.mul(sq, sq)
        return out.contiguous()

    def powers_host_base(self, base_int: int, n: int, device, scale: int = 1):
        """[scale * base^i] for i < n as (L, n) Montgomery, for a base known
        on the host: two ~sqrt(n) power tables and one broadcast mul."""
        spec = self.spec
        p = spec.modulus
        lo_n = 1 << max(1, ((n - 1).bit_length() + 1) // 2)
        hi_n = -(-n // lo_n)
        lo = [1] * lo_n
        for i in range(1, lo_n):
            lo[i] = lo[i - 1] * base_int % p
        stride = lo[-1] * base_int % p
        hi = [scale % p] * hi_n
        for i in range(1, hi_n):
            hi[i] = hi[i - 1] * stride % p
        R = spec.mont_r
        lo_m = self.pack([v * R % p for v in lo], device, to_mont=False)
        hi_m = self.pack([v * R % p for v in hi], device, to_mont=False)
        prod = self.mul(hi_m.movedim(-1, 0)[:, :, None],   # (hi, L, 1)
                        lo_m[None])                         # (1, L, lo)
        return prod.movedim(0, 1).reshape(self.L, hi_n * lo_n)[:, :n] \
            .contiguous()

    def sum_reduce(self, a, axis: int = 0):
        """Modular sum along a batch axis by halving."""
        a = a.movedim(axis, 0)
        n = a.shape[0]
        while n > 1:
            half = n // 2
            s = self.add(a[:half], a[half:2 * half])
            if n % 2:
                s = torch.cat([s, a[2 * half:n]], dim=0)
                n = half + 1
            else:
                n = half
            a = s
        return a[0]

    def dot(self, coeffs, point_powers):
        """Sum over the element axis of coeffs * powers -> (..., L, 1)."""
        prod = self.mul(coeffs, point_powers)
        n = prod.shape[-1]
        while n > 1:
            half = n // 2
            s = self.add(prod[..., :half], prod[..., half:2 * half])
            if n % 2:
                s = torch.cat([s, prod[..., 2 * half:n]], dim=-1)
                n = half + 1
            else:
                n = half
            prod = s
        return prod


FR_SPEC = FieldSpec(
    name="fr", limbs=16,
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001)
FQ_SPEC = FieldSpec(
    name="fq", limbs=24,
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB)


@lru_cache(maxsize=None)
def fr_field() -> LimbField:
    return LimbField(FR_SPEC)


@lru_cache(maxsize=None)
def fq_field() -> LimbField:
    return LimbField(FQ_SPEC)
