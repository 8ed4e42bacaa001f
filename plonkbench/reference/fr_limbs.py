"""Fr arithmetic in plain PyTorch for the reference's vectors: 16 limbs of
16 bits held in int64, limb-major (16, N), every value in Montgomery form
(x R mod r, R = 2^256), canonical (< r).

Written afresh for the reference (it imports nothing of the program): a
schoolbook product and a word-by-word Montgomery reduction on 16-bit
words, so that every intermediate stays below 2^40 in int64.  Runs on the
card in the benchmark and on the CPU in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import R_MOD

LIMBS = 16
MASK = 0xFFFF
MONT_R = (1 << 256) % R_MOD
MONT_R_INV = pow(MONT_R, -1, R_MOD)
NP = (-pow(R_MOD, -1, 1 << 16)) % (1 << 16)


def _limbs(v: int) -> list:
    return [(v >> (16 * i)) & MASK for i in range(LIMBS)]


class FrVec:
    """Vectors of Fr on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.p = self._raw([R_MOD])

    def _raw(self, vals) -> torch.Tensor:
        """(16, N) limbs of the integers as given (no conversion)."""
        buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
        arr = np.frombuffer(buf, dtype="<u2").reshape(-1, LIMBS)
        return torch.from_numpy(arr.T.astype(np.int64)).to(self.device)

    def const(self, v: int) -> torch.Tensor:
        """(16, 1): v in Montgomery form."""
        return self._raw([v % R_MOD * MONT_R % R_MOD])

    def upload(self, vals) -> torch.Tensor:
        """(16, N): canonical integers -> Montgomery form."""
        return self.mul(self._raw(vals), self._raw([MONT_R * MONT_R
                                                    % R_MOD]))

    def to_int(self, t: torch.Tensor) -> int:
        """The one element of a (16, 1) vector, as a canonical integer."""
        return self.sum(t)

    def sum(self, t: torch.Tensor) -> int:
        """sum of the vector's elements, as a canonical integer."""
        s = t.sum(dim=1).tolist()
        acc = sum(v << (16 * i) for i, v in enumerate(s))
        return acc % R_MOD * MONT_R_INV % R_MOD

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> int:
        return self.sum(self.mul(a, b))

    # -- arithmetic ------------------------------------------------------

    @staticmethod
    def _carry(t: torch.Tensor) -> torch.Tensor:
        for i in range(t.shape[0] - 1):
            t[i + 1] += t[i] >> 16
            t[i] &= MASK
        return t

    def _reduce(self, r: torch.Tensor) -> torch.Tensor:
        """Normalised limbs of a value below 2r -> the value mod r."""
        d = self._carry(r - self.p)
        return torch.where(d[-1] < 0, r, d)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a b / R mod r, for a, b (16, N) or (16, 1)."""
        n = max(a.shape[1], b.shape[1])
        t = torch.zeros((2 * LIMBS + 1, n), dtype=torch.int64,
                        device=self.device)
        for i in range(LIMBS):
            t[i:i + LIMBS] += a[i] * b
        p = self.p
        for i in range(LIMBS):
            m = (t[i] * NP) & MASK
            t[i:i + LIMBS] += m * p
            t[i + 1] += t[i] >> 16
        r = self._carry(t[LIMBS:])
        return self._reduce(r[:LIMBS].clone())

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._reduce(self._carry(a + b))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._reduce(self._carry(a - b + self.p))

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse of nonzero x, by a product tree."""
        one = self.const(1)
        levels = []
        cur = x
        while cur.shape[1] > 1:
            if cur.shape[1] % 2:
                cur = torch.cat([cur, one], dim=1)
            levels.append(cur)
            cur = self.mul(cur[:, 0::2], cur[:, 1::2])
        root = self.to_int(cur)
        if root == 0:
            raise ZeroDivisionError("inverse of zero")
        out = self.const(pow(root, -1, R_MOD))
        for lvl in reversed(levels):
            out = out[:, :lvl.shape[1] // 2]
            nxt = torch.empty_like(lvl)
            nxt[:, 0::2] = self.mul(out, lvl[:, 1::2])
            nxt[:, 1::2] = self.mul(out, lvl[:, 0::2])
            out = nxt
        return out[:, :x.shape[1]]

    def prefix(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive prefix products of x."""
        n = x.shape[1]
        if n == 1:
            return x
        if n % 2:
            x = torch.cat([x, self.const(1)], dim=1)
        pairs = self.prefix(self.mul(x[:, 0::2], x[:, 1::2]))
        out = torch.empty_like(x)
        out[:, 1::2] = pairs
        out[:, 0:1] = x[:, 0:1]
        out[:, 2::2] = self.mul(pairs[:, :-1], x[:, 2::2])
        return out[:, :n]

    def powers(self, base: int, n: int) -> torch.Tensor:
        """[base^j for j < n]."""
        out = self.const(1)
        step = base % R_MOD
        while out.shape[1] < n:
            out = torch.cat([out, self.mul(out, self.const(step))], dim=1)
            step = step * step % R_MOD
        return out[:, :n]
