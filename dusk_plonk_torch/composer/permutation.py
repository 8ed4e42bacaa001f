"""Copy-constraint permutation argument bookkeeping.

Re-designed from the behavior of reference src/permutation.rs:
* a witness -> wire-usage map (which (column, gate) slots each witness fills)
* sigma permutations: within each witness's usage list, slot i maps to slot
  i+1 cyclically (src/permutation.rs:108-141)
* lagrange encoding over {w^i, K1 w^i, K2 w^i, K3 w^i} with K1,K2,K3 = 7,13,17
  (src/permutation.rs:28-30,143-168)
* grand product z(X): per-gate numerator/denominator products followed by a
  prefix product (src/permutation.rs:205-300). The host version here is the
  oracle; the device engine computes the same thing with batched inversion
  and an associative scan (ops/fr.py / proving/prover.py).

Wire columns are encoded 0=Left(a), 1=Right(b), 2=Output(o), 3=Fourth(d).
"""

from __future__ import annotations

from ..fields.constants import R_MOD, PERM_K1, PERM_K2, PERM_K3
from ..poly.domain import Domain

KS = (1, PERM_K1, PERM_K2, PERM_K3)


class Permutation:
    def __init__(self):
        # witness index -> list of (column, gate_index)
        self.witness_map: list[list[tuple[int, int]]] = []

    def new_witness(self) -> int:
        self.witness_map.append([])
        return len(self.witness_map) - 1

    def add_witnesses_to_map(self, a: int, b: int, o: int, d: int,
                             gate_index: int) -> None:
        self.witness_map[a].append((0, gate_index))
        self.witness_map[b].append((1, gate_index))
        self.witness_map[o].append((2, gate_index))
        self.witness_map[d].append((3, gate_index))

    def compute_sigma_permutations(self, n: int) -> list[list[tuple[int, int]]]:
        """sigmas[col][gate] = (col', gate') — the next wire slot in the
        witness's cycle (identity for unused slots)."""
        sigmas = [[(col, i) for i in range(n)] for col in range(4)]
        for usages in self.witness_map:
            m = len(usages)
            for i, (col, gate) in enumerate(usages):
                nxt = usages[(i + 1) % m]
                sigmas[col][gate] = nxt
        return sigmas

    def compute_permutation_lagrange(self, sigma_mapping, domain: Domain):
        roots = domain.elements
        return [KS[col] * roots[gate] % R_MOD for (col, gate) in sigma_mapping]

    def compute_sigma_polynomials(self, n: int, domain: Domain):
        """Returns the four sigma polynomials in coefficient form."""
        sigmas = self.compute_sigma_permutations(n)
        return [domain.idft(self.compute_permutation_lagrange(s, domain))
                for s in sigmas]

    def compute_permutation_vec(self, domain: Domain, wires, beta: int,
                                gamma: int, sigma_polys) -> list[int]:
        """Grand-product vector z over the domain (z[0] = 1)."""
        n = domain.size
        sigma_evals = [domain.dft(p) for p in sigma_polys]
        roots = domain.elements
        z = [1] * n
        state = 1
        for i in range(n - 1):
            num = 1
            den = 1
            for col in range(4):
                w = wires[col][i]
                num = num * ((w + beta * KS[col] % R_MOD * roots[i] + gamma) % R_MOD) % R_MOD
                den = den * ((w + beta * sigma_evals[col][i] + gamma) % R_MOD) % R_MOD
            state = state * num % R_MOD * pow(den, -1, R_MOD) % R_MOD
            z[i + 1] = state
        return z
