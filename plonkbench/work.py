"""The yardstick's work counts: the operations and bytes of each measured
layer, as functions of its call's shapes, and the card's peaks.

The counts are of the work, not of the kernels that do it, so they read the
same whatever implements the operation:

  * a field multiply is counted in 32-bit products: an Fr multiply 112 (the
    fewest a Montgomery multiply takes on the card, as
    `csrc/quotient.cuh::fr_mont_mul` issues them), an Fq multiply 300 (a
    12-word CIOS Montgomery multiply: 144 + 144 + 12);
  * an NTT of N points is N/2 log2 N butterflies of one Fr multiply each,
    plus one multiply a point for each scale it applies (the inverse's
    1/N, the coset's g^i; the inverse coset's two fold into one);
  * an MSM of n points with 255-bit scalars is the bucket method's
    additions at the window c that needs fewest, ceil(255 / c) (n +
    2^(c+1)), each a mixed addition of 11 Fq multiplies;
  * the quotient grid is 86 Fr multiplies a point of the 8n coset, its
    formula's count;
  * bytes: each input element read once and each output element written
    once, an Fr element 32 bytes, an affine G1 point 96.

The least time is the larger of products / PEAK_PRODUCTS_PER_S and bytes /
PEAK_BYTES_PER_S, on one NVIDIA H100 SXM at its 700 W limit."""

from __future__ import annotations

import math

FR_MUL_PRODUCTS = 112
FQ_MUL_PRODUCTS = 300
MIXED_ADD_FQ_MULS = 11
QUOTIENT_FR_MULS_PER_POINT = 86
FR_BYTES = 32
G1_AFFINE_BYTES = 96
SCALAR_BITS = 255

# 132 SMs x 64 32-bit integer multiplies a clock (compute capability 9.0) x
# 1.98 GHz, the boost clock; HBM3 3.35 TB/s (NVIDIA's H100 SXM data sheet)
PEAK_PRODUCTS_PER_S = 132 * 64 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12

NTT_SCALES = {"dft": 0, "idft": 1, "coset_dft": 1, "coset_idft": 1}


def ntt(kind: str, rows: int, n: int) -> tuple[int, int]:
    """(products, bytes) of `rows` transforms of n points."""
    muls = rows * (n // 2 * int(math.log2(n)) + NTT_SCALES[kind] * n)
    return muls * FR_MUL_PRODUCTS, 2 * rows * n * FR_BYTES


def msm_window(points: int) -> tuple[int, int]:
    """(c, additions) of the bucket method at the window that needs the
    fewest additions for `points` 255-bit scalars."""
    best = None
    for c in range(1, 25):
        adds = math.ceil(SCALAR_BITS / c) * (points + (1 << (c + 1)))
        if best is None or adds < best[1]:
            best = (c, adds)
    return best


def msm(batch: int, points: int) -> tuple[int, int]:
    """(products, bytes) of `batch` MSMs over the same `points` bases."""
    _, adds = msm_window(points)
    products = batch * adds * MIXED_ADD_FQ_MULS * FQ_MUL_PRODUCTS
    nbytes = points * G1_AFFINE_BYTES + batch * points * FR_BYTES \
        + batch * G1_AFFINE_BYTES
    return products, nbytes


def quotient(points: int, planes_in: int) -> tuple[int, int]:
    """(products, bytes) of the quotient grid over `points` coset points
    that reads `planes_in` Fr planes and writes one."""
    products = points * QUOTIENT_FR_MULS_PER_POINT * FR_MUL_PRODUCTS
    return products, (planes_in + 1) * points * FR_BYTES


def least_seconds(products: int, nbytes: int) -> float:
    return max(products / PEAK_PRODUCTS_PER_S, nbytes / PEAK_BYTES_PER_S)
