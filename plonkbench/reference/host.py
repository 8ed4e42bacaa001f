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
# Fq and Fq2 = Fq[u]/(u^2+1), for G1 and G2 arithmetic (the copy leaves out
# the Fq6 / Fq12 tower of the pairing check).
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
