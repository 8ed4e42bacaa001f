"""Host polynomial helpers in coefficient form (lists of canonical ints,
index = degree). Mirrors poly-commit's `Coefficients` surface as consumed by
the reference (evaluate/blind/t/add/scalar-mul; usage sites
src/prover.rs:126-129,412-418; src/prover/proof.rs:186)."""

from __future__ import annotations

from ..fields.constants import R_MOD


def poly_evaluate(coeffs: list[int], point: int) -> int:
    """Horner evaluation."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * point + c) % R_MOD
    return acc


def poly_add(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        x = a[i] if i < len(a) else 0
        y = b[i] if i < len(b) else 0
        out.append((x + y) % R_MOD)
    return out


def poly_scale(a: list[int], s: int) -> list[int]:
    return [c * s % R_MOD for c in a]


def vanishing_eval(n: int, z: int) -> int:
    """Coefficients::t(n, z) = z^n - 1 (reference src/prover/proof.rs:186)."""
    return (pow(z, n, R_MOD) - 1) % R_MOD


def poly_blind(coeffs: list[int], hiding_degree: int, rng) -> list[int]:
    """Add a random multiple of the vanishing polynomial:
    poly += (b_0 + b_1 X + ... + b_h X^h) * (X^n - 1), n = len(coeffs)
    rounded to the domain size = current length.

    Draw order: b_0 first (ascending degree) via Fr::random — this ordering
    is part of the bit-exactness contract (SURVEY.md §7 hard part #1).
    """
    from ..rng.chacha import fr_random
    n = len(coeffs)
    blinders = [fr_random(rng) for _ in range(hiding_degree + 1)]
    out = list(coeffs) + [0] * (hiding_degree + 1)
    for i, b in enumerate(blinders):
        out[n + i] = (out[n + i] + b) % R_MOD   # + b_i X^(n+i)
        out[i] = (out[i] - b) % R_MOD           # - b_i X^i
    return out
