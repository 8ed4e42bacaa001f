"""Host exactness engine: field arithmetic on plain Python integers.

This module is the bit-exactness oracle for the device (JAX/Pallas) kernels.
All values are canonical integers in [0, modulus). Montgomery form is only a
device-side representation; host code works in the canonical domain.

Covers the trait surface the reference consumes from `zkstd`/`bls-12-381`
(usage sites: reference `src/lib.rs:91-94`, `src/commitment_scheme.rs:22`):
add/sub/mul/square/invert/pow/random/from_bytes_wide/to_bytes/to_bits.
"""

from __future__ import annotations

from .constants import R_MOD, Q_MOD, FR_ROOT_OF_UNITY, FR_GENERATOR, FR_TWO_ADICITY


# ---------------------------------------------------------------------------
# Fr (BLS12-381 scalar field) — canonical-int helpers
# ---------------------------------------------------------------------------

def fr_add(a: int, b: int) -> int:
    s = a + b
    return s - R_MOD if s >= R_MOD else s


def fr_sub(a: int, b: int) -> int:
    s = a - b
    return s + R_MOD if s < 0 else s


def fr_neg(a: int) -> int:
    return (R_MOD - a) % R_MOD


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R_MOD


def fr_sq(a: int) -> int:
    return (a * a) % R_MOD


def fr_inv(a: int) -> int:
    """Multiplicative inverse; raises ZeroDivisionError on 0 (the reference's
    `invert()` returns CtOption; callers there unwrap)."""
    return pow(a, -1, R_MOD)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, R_MOD)


def fr_from_bytes_wide(b: bytes) -> int:
    """512-bit little-endian reduction, mirroring bls-12-381's
    `Fr::from_bytes_wide` (= value mod r)."""
    assert len(b) == 64
    return int.from_bytes(b, "little") % R_MOD


def fr_to_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian encoding (Fr::to_bytes /
    to_raw_bytes usage at reference src/lib.rs:300,1069)."""
    return int(a).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= R_MOD:
        raise ValueError("non-canonical Fr encoding")
    return v


def fr_to_bits(a: int) -> list[int]:
    """256 bits, LSB first (Fr::to_bits usage at reference src/lib.rs:888
    iterates .rev() over it together with enumerate ascending powers —
    composed there the i-th processed bit scales 2^i, i.e. LSB-first after
    the .rev(); we expose LSB-first and let callers order)."""
    return [(a >> i) & 1 for i in range(256)]


def fr_batch_inv(values: list[int]) -> list[int]:
    """Montgomery's batch-inversion trick (reference poly-commit
    `batch_inversion`, usage src/prover/proof.rs:579). Zeros are passed
    through as zero (matching the filtered usage in the reference)."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v != 0 else 1) % R_MOD
    inv = pow(prefix[n], -1, R_MOD)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v == 0:
            out[i] = 0
        else:
            out[i] = prefix[i] * inv % R_MOD
            inv = inv * v % R_MOD
    return out


def fr_root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (k <= 32)."""
    assert 0 <= k <= FR_TWO_ADICITY
    root = FR_ROOT_OF_UNITY
    for _ in range(FR_TWO_ADICITY - k):
        root = root * root % R_MOD
    return root


# ---------------------------------------------------------------------------
# Fq and its extension tower Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-(u+1)),
# Fq12 = Fq6[w]/(w^2-v).  Only needed host-side for the pairing check
# (reference src/commitment_scheme.rs:56-62) and G2 arithmetic.
# ---------------------------------------------------------------------------

def fq_add(a, b):
    s = a + b
    return s - Q_MOD if s >= Q_MOD else s


def fq_sub(a, b):
    s = a - b
    return s + Q_MOD if s < 0 else s


def fq_mul(a, b):
    return (a * b) % Q_MOD


def fq_inv(a):
    return pow(a, -1, Q_MOD)


def fq_neg(a):
    return (Q_MOD - a) % Q_MOD


def fq_sqrt(a):
    """Square root in Fq (q ≡ 3 mod 4). Returns None if non-residue."""
    s = pow(a, (Q_MOD + 1) // 4, Q_MOD)
    return s if s * s % Q_MOD == a else None


# Fq2 as tuples (c0, c1) meaning c0 + c1*u with u^2 = -1.

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return (fq_add(a[0], b[0]), fq_add(a[1], b[1]))


def fq2_sub(a, b):
    return (fq_sub(a[0], b[0]), fq_sub(a[1], b[1]))


def fq2_neg(a):
    return (fq_neg(a[0]), fq_neg(a[1]))


def fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0 % Q_MOD
    t1 = a1 * b1 % Q_MOD
    c0 = (t0 - t1) % Q_MOD
    c1 = ((a0 + a1) * (b0 + b1) - t0 - t1) % Q_MOD
    return (c0, c1)


def fq2_sq(a):
    a0, a1 = a
    c0 = (a0 + a1) * (a0 - a1) % Q_MOD
    c1 = 2 * a0 * a1 % Q_MOD
    return (c0, c1)


def fq2_mul_scalar(a, s):
    return (a[0] * s % Q_MOD, a[1] * s % Q_MOD)


def fq2_inv(a):
    a0, a1 = a
    t = pow((a0 * a0 + a1 * a1) % Q_MOD, -1, Q_MOD)
    return (a0 * t % Q_MOD, (Q_MOD - a1) * t % Q_MOD)


def fq2_conj(a):
    return (a[0], fq_neg(a[1]))


def fq2_mul_by_nonresidue(a):
    """Multiply by (u+1): (c0 - c1) + (c0 + c1) u."""
    a0, a1 = a
    return ((a0 - a1) % Q_MOD, (a0 + a1) % Q_MOD)


def fq2_frobenius(a):
    return fq2_conj(a)


# Fq6 as tuples of Fq2: (c0, c1, c2) = c0 + c1 v + c2 v^2, v^3 = u+1

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_by_nonresidue(
        fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)),
        fq2_mul_by_nonresidue(t2))
    c2 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)),
        t1)
    return (c0, c1, c2)


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_nonresidue(a):
    """Multiply by v: (c2*(u+1), c0, c1)."""
    return (fq2_mul_by_nonresidue(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_by_nonresidue(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_by_nonresidue(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_inv(fq2_add(
        fq2_mul(a0, c0),
        fq2_mul_by_nonresidue(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2)))))
    return (fq2_mul(t, c0), fq2_mul(t, c1), fq2_mul(t, c2))


# Fq12 as pairs of Fq6: (c0, c1) = c0 + c1 w, w^2 = v

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_nonresidue(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sq(a):
    a0, a1 = a
    t = fq6_mul(a0, a1)
    c0 = fq6_sub(
        fq6_mul(fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_nonresidue(a1))),
        fq6_add(t, fq6_mul_by_nonresidue(t)))
    c1 = fq6_add(t, t)
    return (c0, c1)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    t = fq6_inv(fq6_sub(fq6_sq(a0), fq6_mul_by_nonresidue(fq6_sq(a1))))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


# Frobenius coefficients for Fq2/Fq6/Fq12 (computed once at import).

def _frob_coeffs():
    # gamma_{1,j} = (u+1)^((q-1)*j/6) for Fq12/Fq6 Frobenius
    e = (Q_MOD - 1) // 6
    # (u+1)^e in Fq2 computed by exponentiation
    def fq2_pow(a, n):
        result = FQ2_ONE
        base = a
        while n:
            if n & 1:
                result = fq2_mul(result, base)
            base = fq2_sq(base)
            n >>= 1
        return result
    xi = (1, 1)
    return [fq2_pow(xi, e * j) for j in range(6)]


_FROB = _frob_coeffs()


def fq6_frobenius(a):
    c0 = fq2_frobenius(a[0])
    c1 = fq2_mul(fq2_frobenius(a[1]), _FROB[2])
    c2 = fq2_mul(fq2_frobenius(a[2]), _FROB[4])
    return (c0, c1, c2)


def fq12_frobenius(a):
    c0 = fq6_frobenius(a[0])
    c1 = fq6_frobenius(a[1])
    c1 = tuple(fq2_mul(x, _FROB[1]) for x in c1)
    return (c0, c1)


def fq12_pow(a, n):
    result = FQ12_ONE
    base = a
    while n:
        if n & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        n >>= 1
    return result
