"""Copy-constraint permutation argument bookkeeping.

Re-designed from the behavior of reference src/permutation.rs:
* a witness -> wire-usage map (which (column, gate) slots each witness fills)
* sigma permutations: within each witness's usage list, slot i maps to slot
  i+1 cyclically (src/permutation.rs:108-141)
* lagrange encoding over {w^i, K1 w^i, K2 w^i, K3 w^i} with K1,K2,K3 = 7,13,17
  (src/permutation.rs:28-30,143-168)
* grand product z(X): per-gate numerator/denominator products followed by a
  prefix product (src/permutation.rs:205-300); the reference's check
  (check.py) computes it over the witness's wire values.

Wire columns are encoded 0=Left(a), 1=Right(b), 2=Output(o), 3=Fourth(d).
"""

from __future__ import annotations

from .constants import PERM_K1, PERM_K2, PERM_K3

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
