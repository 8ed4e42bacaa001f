"""JubJub: the twisted Edwards curve embedded over BLS12-381's Fr.

-x^2 + y^2 = 1 + d x^2 y^2   with   d = -(10240/10241)

The reference uses the unmounted `jub-jub` crate for gadget witness synthesis
only (reference src/lib.rs:85,390-540,809-850): point add/double, affine
coordinates, and width-2 windowed NAF.  Circuit gate math is over Fr, so this
stays host-side Python.

Points are (x, y) tuples; the identity is (0, 1).
"""

from __future__ import annotations

from ..fields.constants import (R_MOD, JUBJUB_D, JUBJUB_FP, JUBJUB_COFACTOR,
                                JUBJUB_GENERATOR_X, JUBJUB_GENERATOR_Y)

D = JUBJUB_D
IDENTITY = (0, 1)


def is_on_curve(p) -> bool:
    x, y = p
    lhs = (-x * x + y * y) % R_MOD
    rhs = (1 + D * x % R_MOD * x % R_MOD * y % R_MOD * y) % R_MOD
    return lhs == rhs


def add(p, q):
    """Complete twisted Edwards addition (a = -1)."""
    x1, y1 = p
    x2, y2 = q
    x1y2 = x1 * y2 % R_MOD
    y1x2 = y1 * x2 % R_MOD
    y1y2 = y1 * y2 % R_MOD
    x1x2 = x1 * x2 % R_MOD
    dxy = D * x1y2 % R_MOD * y1x2 % R_MOD
    x3 = (x1y2 + y1x2) * pow(1 + dxy, -1, R_MOD) % R_MOD
    y3 = (y1y2 + x1x2) * pow(1 - dxy, -1, R_MOD) % R_MOD
    return (x3, y3)


def neg(p):
    return ((R_MOD - p[0]) % R_MOD, p[1])


def double(p):
    return add(p, p)


def mul(p, k: int):
    """Scalar multiplication; k reduced mod the full group order is NOT
    applied (callers pass Fp scalars or raw integers, mirroring the crate)."""
    acc = IDENTITY
    base = p
    while k:
        if k & 1:
            acc = add(acc, base)
        base = add(base, base)
        k >>= 1
    return acc


def _sqrt_fr(a: int):
    """Tonelli-Shanks square root in Fr (2-adicity 32)."""
    if a == 0:
        return 0
    if pow(a, (R_MOD - 1) // 2, R_MOD) != 1:
        return None
    # r - 1 = t * 2^32 with t odd
    t = (R_MOD - 1) >> 32
    z = 7  # multiplicative generator (non-residue since r = 1 mod 2)
    # ensure z is a non-residue
    assert pow(z, (R_MOD - 1) // 2, R_MOD) == R_MOD - 1
    m = 32
    c = pow(z, t, R_MOD)
    u = pow(a, t, R_MOD)
    root = pow(a, (t + 1) // 2, R_MOD)
    while u != 1:
        # find least i with u^(2^i) = 1
        i = 0
        v = u
        while v != 1:
            v = v * v % R_MOD
            i += 1
        b = pow(c, 1 << (m - i - 1), R_MOD)
        m = i
        c = b * b % R_MOD
        u = u * c % R_MOD
        root = root * b % R_MOD
    return root


# The published dusk-jubjub `GENERATOR` (prime-order subgroup generator;
# see fields/constants.py for provenance).  Used wherever the reference uses
# `ADDITIVE_GENERATOR`/`GENERATOR_EXTENDED` (reference src/lib.rs:85,
# tests/boolean.rs:200, README.md:64).
GENERATOR = (JUBJUB_GENERATOR_X, JUBJUB_GENERATOR_Y)


def compute_windowed_naf(scalar: int, width: int) -> list[int]:
    """Width-w windowed NAF, LSB-first, padded to 256 entries, mirroring
    jub-jub's `compute_windowed_naf` as used at reference src/lib.rs:432-435
    (the gadget consumes it `.rev()`, i.e. MSB-first; width=2 produces digits
    in {-1, 0, 1} and the gadget errors on anything else, src/lib.rs:452)."""
    k = scalar % JUBJUB_FP
    digits = []
    while k > 0:
        if k & 1:
            d = k % (1 << width)
            if d > (1 << (width - 1)):
                d -= 1 << width
            k -= d
        else:
            d = 0
        digits.append(d)
        k >>= 1
    digits += [0] * (256 - len(digits))
    return digits[:256]
