"""Host ate pairing for BLS12-381.

The reference consumes `TatePairing::multi_miller_loop(...).final_exp()`
from the unmounted `ec-pairing` crate and only ever compares the result to
the Gt identity (reference src/commitment_scheme.rs:56-62); Gt values are
never serialized, so any fixed bilinear non-degenerate pairing is behavior-
compatible.  We implement the optimal ate pairing with an affine Miller loop:
the G2 point stays on the twist E'(Fq2) and line functions are emitted
directly in a sparse Fq12 basis (lines are pre-scaled by the subfield element
xi = u+1, which the final exponentiation kills).

Derivation of the sparse line form: with the untwist
(x', y') -> (x'/v, y'/(v*w)), a line of slope lam' on the twist evaluates at
P=(xp, yp) as  l = yp - lam'*xp*(w/v) + (lam'*x_T - y_T)*(w/v^2).  Using
1/v = v^2/xi and 1/v^2 = v/xi and scaling by xi (subfield, killed by final
exp):  l = yp*xi + w*( (lam'*x_T - y_T)*v - lam'*xp*v^2 ).
"""

from __future__ import annotations

from ..fields.constants import Q_MOD, R_MOD, BLS_X
from ..fields.host import (
    FQ12_ONE, fq12_mul, fq12_sq, fq12_conj, fq12_inv, fq12_frobenius, fq12_pow,
    fq2_mul, fq2_sq, fq2_sub, fq2_inv, fq2_neg, fq2_mul_scalar,
    FQ2_ZERO,
)

# hard part exponent of the final exponentiation: (q^4 - q^2 + 1) / r
_HARD_EXP = (Q_MOD ** 4 - Q_MOD ** 2 + 1) // R_MOD


def _line_eval(t, q2, p):
    """Line through twist points t and q2 (tangent when t == q2), evaluated
    at p in G1.  Returns (sparse Fq12 line, t + q2 on the twist)."""
    xt, yt = t
    xq, yq = q2
    xp, yp = p
    if xt == xq and yt == yq:
        lam = fq2_mul(fq2_mul_scalar(fq2_sq(xt), 3),
                      fq2_inv(fq2_mul_scalar(yt, 2)))
    elif xt == xq:
        raise ArithmeticError(
            "vertical line in Miller loop (inputs outside expected subgroups)")
    else:
        lam = fq2_mul(fq2_sub(yq, yt), fq2_inv(fq2_sub(xq, xt)))
    x3 = fq2_sub(fq2_sub(fq2_sq(lam), xt), xq)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
    l_c0 = (fq2_mul_scalar((1, 1), yp), FQ2_ZERO, FQ2_ZERO)
    l_c1 = (FQ2_ZERO,
            fq2_sub(fq2_mul(lam, xt), yt),
            fq2_neg(fq2_mul_scalar(lam, xp)))
    return (l_c0, l_c1), (x3, y3)


def miller_loop(pairs):
    """Product of Miller loops over [(g1_affine, g2_affine)] pairs.
    Identity entries contribute the unit (matching multi_miller_loop)."""
    live = [(p, q) for (p, q) in pairs if p is not None and q is not None]
    f = FQ12_ONE
    ts = [q for (_p, q) in live]
    bits = bin(BLS_X)[3:]  # MSB-first, skipping the leading 1
    for bit in bits:
        f = fq12_sq(f)
        for i, (p, q) in enumerate(live):
            l, t2 = _line_eval(ts[i], ts[i], p)
            ts[i] = t2
            f = fq12_mul(f, l)
        if bit == "1":
            for i, (p, q) in enumerate(live):
                l, t2 = _line_eval(ts[i], q, p)
                ts[i] = t2
                f = fq12_mul(f, l)
    # BLS x is negative: conjugate (equals inversion up to factors killed by
    # the final exponentiation)
    return fq12_conj(f)


def final_exponentiation(f):
    """f^((q^12-1)/r). Easy part exactly; hard part by plain exponentiation
    with (q^4-q^2+1)/r (host-only path; performance-irrelevant)."""
    f = fq12_mul(fq12_conj(f), fq12_inv(f))          # f^(q^6 - 1)
    f = fq12_mul(fq12_frobenius(fq12_frobenius(f)), f)  # ^(q^2 + 1)
    return fq12_pow(f, _HARD_EXP)


def pairing(p, q):
    """e(P, Q) for P in G1, Q in G2 (affine or None)."""
    return final_exponentiation(miller_loop([(p, q)]))


_G2_PREPARE_CACHE: dict = {}


def multi_pairing_is_one(pairs) -> bool:
    """multi_miller_loop(pairs).final_exp() == Gt identity — the exact
    shape of the reference's batch_check (src/commitment_scheme.rs:56-62).

    Routed through the native C++ engine when available (differential-tested
    against this module's Python path in tests/test_native.py); the Python
    path is the fallback oracle.  G2 line coefficients are prepared once
    per point and cached (the verifier's h / beta_h never change —
    the reference's prepared_h / prepared_beta_h design,
    src/commitment_scheme.rs:51-58): the unprepared affine Miller loop
    pays a ~380-mul Fq2 inversion per step per pair (~18 ms for the
    2-pair check, measured); the prepared replay is ~1 ms."""
    from .. import native
    if native.available():
        if native.has_prepared_pairing():
            prepared = []
            for _, q in pairs:
                pre = _G2_PREPARE_CACHE.get(q)
                if pre is None:
                    pre = native.g2_prepare(q)
                    if len(_G2_PREPARE_CACHE) < 64:
                        _G2_PREPARE_CACHE[q] = pre
                prepared.append(pre)
            return native.pairing_is_one_prepared(
                [p for p, _ in pairs], prepared)
        return native.pairing_is_one(pairs)
    return final_exponentiation(miller_loop(pairs)) == FQ12_ONE
