"""Host BLS12-381 G1/G2 arithmetic and point serialization.

Points are represented as affine tuples or `None` for the identity:
  G1: (x, y) with x, y in Fq          — y^2 = x^3 + 4
  G2: ((x0,x1), (y0,y1)) over Fq2     — y^2 = x^3 + 4(u+1)

The reference consumes these from the unmounted `bls-12-381` crate
(usage: reference src/commitment_scheme.rs:30-54, src/prover/proof.rs:442-527).
Serialization follows the zkcrypto/ZCash 48-byte compressed convention
(big-endian x, flag bits in the top byte), which is the interop format for
`Commitment` encode/decode.
"""

from __future__ import annotations

from .constants import (
    Q_MOD, R_MOD, G1_GEN_X, G1_GEN_Y, G2_GEN_X, G2_GEN_Y,
)
from . import host as F

G1_GENERATOR = (G1_GEN_X, G1_GEN_Y)
G2_GENERATOR = (G2_GEN_X, G2_GEN_Y)


# ---------------------------------------------------------------------------
# G1 (affine with None identity; internally Jacobian for speed)
# ---------------------------------------------------------------------------

def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x % Q_MOD) * x - 4) % Q_MOD == 0


def _jac_from_affine(p):
    if p is None:
        return (1, 1, 0)
    return (p[0], p[1], 1)


def _jac_to_affine(p):
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, Q_MOD)
    zi2 = zi * zi % Q_MOD
    return (x * zi2 % Q_MOD, y * zi2 % Q_MOD * zi % Q_MOD)


def _jac_double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % Q_MOD
    b = y * y % Q_MOD
    c = b * b % Q_MOD
    d = 2 * ((x + b) * (x + b) - a - c) % Q_MOD
    e = 3 * a % Q_MOD
    f = e * e % Q_MOD
    x3 = (f - 2 * d) % Q_MOD
    y3 = (e * (d - x3) - 8 * c) % Q_MOD
    z3 = 2 * y * z % Q_MOD
    return (x3, y3, z3)


def _jac_add(p, q):
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1z1 = z1 * z1 % Q_MOD
    z2z2 = z2 * z2 % Q_MOD
    u1 = x1 * z2z2 % Q_MOD
    u2 = x2 * z1z1 % Q_MOD
    s1 = y1 * z2 % Q_MOD * z2z2 % Q_MOD
    s2 = y2 * z1 % Q_MOD * z1z1 % Q_MOD
    if u1 == u2:
        if s1 != s2:
            return (1, 1, 0)
        return _jac_double(p)
    h = (u2 - u1) % Q_MOD
    i = 4 * h * h % Q_MOD
    j = h * i % Q_MOD
    rr = 2 * (s2 - s1) % Q_MOD
    v = u1 * i % Q_MOD
    x3 = (rr * rr - j - 2 * v) % Q_MOD
    y3 = (rr * (v - x3) - 2 * s1 * j) % Q_MOD
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % Q_MOD * h % Q_MOD
    return (x3, y3, z3)


def g1_add(p, q):
    return _jac_to_affine(_jac_add(_jac_from_affine(p), _jac_from_affine(q)))


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (Q_MOD - p[1]) % Q_MOD)


def g1_double(p):
    return _jac_to_affine(_jac_double(_jac_from_affine(p)))


def g1_mul(p, k: int):
    """Scalar multiplication (k taken mod r), double-and-add."""
    k %= R_MOD
    acc = (1, 1, 0)
    base = _jac_from_affine(p)
    while k:
        if k & 1:
            acc = _jac_add(acc, base)
        base = _jac_double(base)
        k >>= 1
    return _jac_to_affine(acc)


def g1_to_bytes(p) -> bytes:
    """48-byte compressed encoding (zkcrypto convention): big-endian x with
    bit7 of byte0 = compressed flag, bit6 = infinity, bit5 = y lexicographic
    sign (y > (q-1)/2)."""
    if p is None:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x, y = p
    out = bytearray(int(x).to_bytes(48, "big"))
    out[0] |= 0x80
    if y > (Q_MOD - 1) // 2:
        out[0] |= 0x20
    return bytes(out)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = F.fq2_sq(y)
    rhs = F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), _B2)
    return lhs == rhs


def g2_neg(p):
    if p is None:
        return None
    return (p[0], F.fq2_neg(p[1]))


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 != y2:
            return None
        # doubling
        lam = F.fq2_mul(
            F.fq2_mul_scalar(F.fq2_sq(x1), 3),
            F.fq2_inv(F.fq2_mul_scalar(y1, 2)))
    else:
        lam = F.fq2_mul(F.fq2_sub(y2, y1), F.fq2_inv(F.fq2_sub(x2, x1)))
    x3 = F.fq2_sub(F.fq2_sub(F.fq2_sq(lam), x1), x2)
    y3 = F.fq2_sub(F.fq2_mul(lam, F.fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k: int):
    k %= R_MOD
    acc = None
    base = p
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc

