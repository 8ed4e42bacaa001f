"""G1 point arithmetic (BLS12-381, y^2 = x^3 + 4) over Fq limb tensors.

Counterpart of dusk_plonk_tpu/ops/ec.py.  Points are tuples (X, Y, Z) of
(..., 24, N) int32 Montgomery limb tensors; identity = (0, 1, 0).  Addition
is the complete RCB15 formula (a = 0), in the JAX package's step order, so
raw projective outputs agree limb for limb; `double_formula` is RCB15's
doubling (K7 doubles with it, so K7's outputs are the JAX kernel's points
in other representatives).  `add` is kernel K9
(ops/kernels.py::ec_add) and `add_mixed` kernel K10 (ec_add_mixed; the
MSM's mixed adds run inside its scan kernels instead).  The step-axis
methods `scan_mixed`, `scan_mixed_em`, `sum_steps`, `scan_excl`,
`double_add` and `combine` are kernels K11a, K12, K11b, K4, K7 and K8.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..curves.bls import G1_GENERATOR

from . import kernels
from .limb import fq_field, int_to_limbs


class DeviceG1:
    def __init__(self):
        self.F = fq_field()
        spec = self.F.spec

        def mont(v):
            return int_to_limbs(spec, v * spec.mont_r % spec.modulus)[:, None]
        self._np_identity = (mont(0), mont(1), mont(0))        # (24, 1) each
        # affine generator: the scalar-0 pad point of MSM inputs, which
        # must stay strictly affine (the mixed-add scan)
        self._np_generator = (mont(G1_GENERATOR[0]), mont(G1_GENERATOR[1]))
        self._dev: dict = {}

    def _const(self, name, device):
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            src = getattr(self, "_np_" + name)
            t = tuple(torch.from_numpy(c.copy()).to(device) for c in src)
            self._dev[key] = t
        return t

    def identity(self, device):
        """Identity as ((24, 1),)*3."""
        return self._const("identity", device)

    def generator_affine(self, device):
        """Affine generator as ((24, 1),)*2, Montgomery."""
        return self._const("generator", device)

    # -- host <-> device ------------------------------------------------------

    def pack_points(self, affine_points, device):
        """[(x, y) | None] -> ((24, N),)*3 projective Montgomery."""
        xs, ys, zs = [], [], []
        for p in affine_points:
            if p is None:
                xs.append(0); ys.append(1); zs.append(0)
            else:
                xs.append(p[0]); ys.append(p[1]); zs.append(1)
        F = self.F
        return (F.pack(xs, device), F.pack(ys, device), F.pack(zs, device))

    def affine(self, pts):
        """Projective ((24, N),)*3 -> the same points with Z = 1 (Montgomery),
        the identity as (0, 1, 0): one batched Fermat inverse of Z on the
        device."""
        F = self.F
        X, Y, Z = pts
        zinv = F.inv(Z)                                      # 0 stays 0
        inf = (Z == 0).all(dim=-2, keepdim=True)
        one = F.const("one_mont", Z.device)
        return (F.mul(X, zinv), torch.where(inf, one, F.mul(Y, zinv)),
                torch.where(inf, 0, one))

    def unpack_points(self, aff):
        """Affine ((24, N),)*3 (Z in {0, 1}) -> [(x, y) | None], one fetch
        per coordinate."""
        F = self.F
        ax, ay = F.unpack(aff[0]), F.unpack(aff[1])
        inf = (aff[2] == 0).all(dim=-2).reshape(-1).tolist()
        return [None if i else (x, y) for x, y, i in zip(ax, ay, inf)]

    def to_affine(self, pts):
        """Projective ((24, N),)*3 -> [(x, y) | None]."""
        return self.unpack_points(self.affine(pts))

    # -- complete addition (RCB15 alg. 7, a = 0) ------------------------------------

    @staticmethod
    def _mul12(F, x):
        """12 x = 8x + 4x via 4 modular adds (b3 = 12)."""
        x2 = F.add(x, x)
        x4 = F.add(x2, x2)
        x8 = F.add(x4, x4)
        return F.add(x8, x4)

    def add(self, p, q):
        """Complete addition, kernel K9 (operands broadcast to one shape)."""
        shape = torch.broadcast_shapes(*(c.shape for c in p + q))
        p = tuple(c.expand(shape).contiguous() for c in p)
        q = tuple(c.expand(shape).contiguous() for c in q)
        return kernels.ec_add(self, p, q)

    def add_formula(self, p, q, mul):
        """RCB15 complete addition with the given field multiply
        (dusk_plonk_tpu/ops/ec.py::DeviceG1._add_xla, step for step)."""
        F = self.F
        x1, y1, z1 = p
        x2, y2, z2 = q
        t0 = mul(x1, x2)
        t1 = mul(y1, y2)
        t2 = mul(z1, z2)
        t3 = mul(F.add(x1, y1), F.add(x2, y2))
        t3 = F.sub(t3, F.add(t0, t1))              # x1y2 + x2y1
        t4 = mul(F.add(y1, z1), F.add(y2, z2))
        t4 = F.sub(t4, F.add(t1, t2))              # y1z2 + y2z1
        x3 = mul(F.add(x1, z1), F.add(x2, z2))
        y3 = F.sub(x3, F.add(t0, t2))              # x1z2 + x2z1
        x3 = F.add(t0, t0)
        t0 = F.add(x3, t0)                         # 3 x1x2
        t2 = self._mul12(F, t2)                    # b3 z1z2
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = self._mul12(F, y3)                    # b3 (x1z2 + x2z1)
        x3 = mul(t4, y3)
        t2 = mul(t3, t1)
        x3 = F.sub(t2, x3)
        y3 = mul(y3, t0)
        t1 = mul(t1, z3)
        y3 = F.add(t1, y3)
        t0 = mul(t0, t3)
        z3 = mul(z3, t4)
        z3 = F.add(z3, t0)
        return (x3, y3, z3)

    def double_formula(self, p, mul):
        """2p by RCB15 algorithm 9 (a = 0, b3 = 12), 8 multiplies, with the
        given field multiply; the identity maps to itself.  The step order
        of csrc/ec.cuh::g1_dbl."""
        F = self.F
        x, y, z = p
        t0 = mul(y, y)
        z3 = F.add(t0, t0)
        z3 = F.add(z3, z3)
        z3 = F.add(z3, z3)                         # 8 y^2
        t1 = mul(y, z)
        t2 = mul(z, z)
        t2 = self._mul12(F, t2)                    # b3 z^2
        x3 = mul(t2, z3)
        y3 = F.add(t0, t2)
        z3 = mul(t1, z3)
        t1 = F.add(t2, t2)
        t2 = F.add(t1, t2)                         # 3 b3 z^2
        t0 = F.sub(t0, t2)
        y3 = mul(t0, y3)
        y3 = F.add(x3, y3)
        t1 = mul(x, y)
        x3 = mul(t0, t1)
        x3 = F.add(x3, x3)
        return (x3, y3, z3)

    def add_mixed(self, p, q2):
        """p + (x2, y2) with q strictly affine (z2 = 1, never the identity),
        kernel K10 (operands broadcast to one shape)."""
        shape = torch.broadcast_shapes(*(c.shape for c in p + q2))
        p = tuple(c.expand(shape).contiguous() for c in p)
        q2 = tuple(c.expand(shape).contiguous() for c in q2)
        return kernels.ec_add_mixed(self, p, q2)

    def add_mixed_formula(self, p, q2, mul):
        """RCB15 mixed addition, 11 multiplies
        (dusk_plonk_tpu/ops/ec.py::DeviceG1._add_mixed_xla, step for step)."""
        F = self.F
        x1, y1, z1 = p
        x2, y2 = q2
        t0 = mul(x1, x2)
        t1 = mul(y1, y2)
        t3 = mul(F.add(x1, y1), F.add(x2, y2))
        t3 = F.sub(t3, F.add(t0, t1))              # x1y2 + x2y1
        t4 = F.add(y1, mul(y2, z1))                # y1 + y2 z1
        y3 = F.add(x1, mul(x2, z1))                # x1 + x2 z1
        x3 = F.add(t0, t0)
        t0 = F.add(x3, t0)                         # 3 x1x2
        t2 = self._mul12(F, z1)                    # b3 z1
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = self._mul12(F, y3)                    # b3 (x1 + x2 z1)
        x3 = mul(t4, y3)
        t2 = mul(t3, t1)
        x3 = F.sub(t2, x3)
        y3 = mul(y3, t0)
        t1 = mul(t1, z3)
        y3 = F.add(t1, y3)
        t0 = mul(t0, t3)
        z3 = mul(z3, t4)
        z3 = F.add(z3, t0)
        return (x3, y3, z3)

    def scan_mixed(self, g):
        """g (cl, 48, lanes) affine steps -> per-lane inclusive prefix sums
        ((cl, 24, lanes),)*3 from the identity, kernel K11a."""
        return kernels.ec_scan_mixed(self, g)

    def scan_mixed_em(self, g):
        """As scan_mixed, element-major: (cl, lanes, 72) rows of (x, y, z),
        kernel K12."""
        return kernels.ec_scan_mixed_em(self, g)

    def sum_steps(self, g):
        """g ((steps, 24, lanes),)*3 -> per-lane sum ((24, lanes),)*3 from
        the identity, kernel K11b."""
        return kernels.ec_sum_steps(self, g)

    def scan_excl(self, g):
        """g ((steps, 24, lanes),)*3 -> per-lane exclusive prefix sums
        ((steps, 24, lanes),)*3 (identity at step 0), kernel K4."""
        return kernels.ec_scan_excl(self, g)

    def double_add(self, a, b, k: int):
        """2^k a + b on ((24, lanes),)*3 points, kernel K7."""
        return kernels.ec_double_add(self, a, b, k)

    def combine(self, g, c: int):
        """Window totals ((W, 24, lanes),)*3, MSB window first ->
        sum_w 2^(c (W-1-w)) T_w as ((24, lanes),)*3, kernel K8."""
        return kernels.ec_combine(self, g, c)

    def neg(self, p):
        x, y, z = p
        return (x, self.F.neg(y), z)

    def select(self, cond, p, q):
        """cond (..., N) bool -> p or q, per lane."""
        F = self.F
        return tuple(F.select(cond, a, b) for a, b in zip(p, q))

    def broadcast_identity(self, batch_shape, n: int, device):
        """Identity as (batch_shape..., 24, n) contiguous components."""
        return tuple(c.expand(tuple(batch_shape) + (self.F.L, n)).contiguous()
                     for c in self.identity(device))


@lru_cache(maxsize=None)
def device_g1() -> DeviceG1:
    return DeviceG1()
