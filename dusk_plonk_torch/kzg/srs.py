"""KZG10 public parameters (SRS), commitments, and aggregate openings.

Mirrors the surface the reference consumes from `zksnarks::plonk::PlonkParams`
(usage: tests/range.rs:26 `setup(k, rng)`; src/key.rs:82 `.trim`;
src/prover.rs:133-136 `.commit`; src/prover.rs:422-452
`.compute_aggregate_witness`; src/key.rs:320 `.verification_key()`).

Commitments run through a pluggable MSM engine: the host Pippenger by default,
the device Pippenger when an `msm_fn` is injected — the prover injects
the device engine (see proving/prover.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import R_MOD
from ..curves import bls
from ..rng.chacha import fr_random


@dataclass
class EvaluationKey:
    """Verifier-side opening key (poly-commit `EvaluationKey`; fields g,
    prepared_beta_h, prepared_h visible at reference
    src/commitment_scheme.rs:51-58)."""
    g: tuple                 # G1 generator
    h: tuple                 # G2 generator
    beta_h: tuple            # tau * G2


class PlonkParams:
    """Powers-of-tau SRS in G1 plus (h, tau*h) in G2."""

    def __init__(self, powers: list, h, beta_h, packed=None, g=None):
        self.powers = powers            # [tau^i * G1] affine (None if packed)
        self.h = h
        self.beta_h = beta_h
        self.msm_fn = None              # injected device MSM: (points, scalars) -> point
        # packed: ((24,N),)*3 Montgomery limb planes of the affine points,
        # uint32 numpy (the JAX package's form, from_packed_npz) or int32
        # torch tensors (setup_device) — the device-ready SRS form
        self.packed = packed
        self._g = g                     # generator affine (packed mode)

    def n_powers(self) -> int:
        return self.packed[0].shape[-1] if self.packed is not None \
            else len(self.powers)

    @classmethod
    def from_packed_npz(cls, path) -> "PlonkParams":
        """Load the pre-packed Montgomery limb-plane SRS (written by
        tools/gen_srs20.py): ~1 s for 2^20 points vs minutes of per-point
        Python for the SCALE form.  Host `powers` are unavailable; only
        the device compile/prove path works."""
        import numpy as np
        from ..proving.proof import _g1_unscale, _g2_unscale
        z = np.load(path)
        packed = tuple(z[k].astype(np.uint32) for k in ("tx", "ty", "tz"))
        h = _g2_unscale(z["h"].tobytes())
        beta_h = _g2_unscale(z["beta_h"].tobytes())
        g = _g1_unscale(z["g"].tobytes())
        return cls(None, h, beta_h, packed=packed, g=g)

    def to_bytes(self) -> bytes:
        """SCALE layout (reference `PlonkParams` persistence surface,
        SURVEY.md §5.4): compact(len) ++ len x G1Affine(97B) ++
        G2Affine h (193B) ++ G2Affine beta_h."""
        from ..proving.proof import (_g1_scale, _g2_scale,
                                     scale_compact_encode)
        out = [scale_compact_encode(len(self.powers))]
        out.extend(_g1_scale(p) for p in self.powers)
        out.append(_g2_scale(self.h))
        out.append(_g2_scale(self.beta_h))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PlonkParams":
        from ..proving.proof import (_g1_unscale, _g2_unscale,
                                     scale_compact_decode)
        n, off = scale_compact_decode(data, 0)
        if len(data) != off + 97 * n + 193 * 2:
            raise ValueError(f"bad PlonkParams length {len(data)}")
        powers = [_g1_unscale(data[off + 97 * i:off + 97 * (i + 1)])
                  for i in range(n)]
        off += 97 * n
        h = _g2_unscale(data[off:off + 193])
        beta_h = _g2_unscale(data[off + 193:off + 386])
        return cls(powers, h, beta_h)

    @classmethod
    def setup(cls, k: int, rng) -> "PlonkParams":
        """Trusted setup for max degree 2^k (tests regenerate this
        deterministically from the seeded StdRng; draw: one Fr::random)."""
        tau = fr_random(rng)
        # 2^k plus the max blinding degree (6): blinded wires reach degree
        # n+2 and the t_4 quotient chunk n+5 even when the circuit occupies
        # the whole domain (upstream dusk-plonk's EXTRA_BLINDING_DEGREE).
        n = (1 << k) + 7
        # fixed-base windowed generation: precompute 8-bit windows of G
        powers = _fixed_base_powers(bls.G1_GENERATOR, tau, n)
        h = bls.G2_GENERATOR
        beta_h = bls.g2_mul(h, tau)
        return cls(powers, h, beta_h)

    @classmethod
    def setup_device(cls, k: int, rng, device="cuda") -> "PlonkParams":
        """Trusted setup on the device: the same RNG draw and the same
        powers as `setup`.  The host builds the 8-bit window tables of G
        (32 x 256 points) and the tau ladder; the device gathers each
        power's 32 window entries and sums them with 31 complete adds
        (kernel K9) over (24, n) lanes, then converts to affine in one
        batch.  The device's affine planes stay on as `packed`
        (Montgomery, z = 1), so device key compilation commits without
        packing the SRS again.  `setup_timings` holds the per-step wall
        times, `setup_peaks` the peak bytes allocated in each (CUDA
        only)."""
        import numpy as np
        import torch
        from ..ops.ec import device_g1
        from ..ops.limb import fr_field
        from ..utils.timing import Marks

        marks = Marks(device)
        tau = fr_random(rng)
        n = (1 << k) + 7

        # host: 8-bit window tables of G, row[d] = d 2^(8w) G
        window = 8
        windows = 32
        G1 = device_g1()
        tables = []
        cur = bls._jac_from_affine(bls.G1_GENERATOR)
        for _ in range(windows):
            row = [None]
            acc = (1, 1, 0)
            for _ in range(1, 1 << window):
                acc = bls._jac_add(acc, cur)
                row.append(bls._jac_to_affine(acc))
            tables.append(row)
            for _ in range(window):
                cur = bls._jac_double(cur)
        flat = [p for row in tables for p in row]
        marks("window_tables")
        tx, ty, tz = G1.pack_points(flat, device)    # (24, 32*256) each
        marks("pack_tables")

        # host: tau power ladder (canonical ints), then 8-bit digits
        scalars = [1] * n
        for i in range(1, n):
            scalars[i] = scalars[i - 1] * tau % R_MOD
        marks("tau_ladder")
        limbs = fr_field().pack_host(scalars)                # (16, n)
        digits = np.stack([limbs & 0xFF, (limbs >> 8) & 0xFF],
                          axis=1).reshape(32, n)             # (32, n)
        flat_idx = torch.from_numpy(
            digits.astype(np.int64) + np.arange(32)[:, None] * 256
        ).to(device)
        marks("pack_ladder")

        # device: a running sum over the 32 gathered windows (three (24, n)
        # buffers live at a time)
        def gather(w):
            return tuple(c.index_select(-1, flat_idx[w]) for c in
                         (tx, ty, tz))

        out = gather(0)
        for w in range(1, windows):
            out = G1.add(out, gather(w))
        marks("device_reduce")
        packed = G1.affine(out)
        powers = G1.unpack_points(packed)
        marks("to_affine")

        h = bls.G2_GENERATOR
        beta_h = bls.g2_mul(h, tau)
        marks("g2")
        params = cls(powers, h, beta_h, packed=packed, g=powers[0])
        params.setup_timings = marks.times
        params.setup_peaks = marks.peaks
        return params

    def trim(self, degree: int) -> "PlonkParams":
        """Truncate to `degree` (reference src/key.rs:82 trims to
        (m+6).next_power_of_two())."""
        if degree + 1 > self.n_powers():
            raise ValueError(
                f"SRS too small: need degree {degree}, have {self.n_powers() - 1}")
        keep = min(degree + 7, self.n_powers())
        if self.packed is not None:
            trimmed = PlonkParams(
                self.powers[:keep] if self.powers is not None else None,
                self.h, self.beta_h,
                packed=tuple(c[:, :keep] for c in self.packed), g=self._g)
        else:
            trimmed = PlonkParams(self.powers[:keep], self.h, self.beta_h)
        trimmed.msm_fn = self.msm_fn
        return trimmed

    def max_degree(self) -> int:
        return self.n_powers() - 1

    def commit(self, coeffs: list[int]):
        """Commitment = MSM(powers[:len], coeffs)."""
        if len(coeffs) > len(self.powers):
            raise ValueError("polynomial degree exceeds SRS")
        if self.msm_fn is not None:
            return self.msm_fn(self.powers[: len(coeffs)], coeffs)
        return bls.g1_msm(self.powers[: len(coeffs)], coeffs)

    def compute_aggregate_witness(self, polys: list[list[int]], point: int,
                                  v_challenge: int) -> list[int]:
        """Fold polynomials by powers of v, then divide by (X - point)
        via Ruffini synthetic division (reference src/prover.rs:422-452)."""
        folded: list[int] = []
        power = 1
        for p in polys:
            if len(p) > len(folded):
                folded += [0] * (len(p) - len(folded))
            for i, c in enumerate(p):
                folded[i] = (folded[i] + c * power) % R_MOD
            power = power * v_challenge % R_MOD
        # synthetic division: quotient of folded / (X - point)
        quotient = [0] * max(len(folded) - 1, 1)
        acc = 0
        for i in range(len(folded) - 1, 0, -1):
            acc = (acc * point + folded[i]) % R_MOD
            quotient[i - 1] = acc
        return quotient

    def verification_key(self) -> EvaluationKey:
        g = self._g if self.packed is not None else self.powers[0]
        return EvaluationKey(g=g, h=self.h, beta_h=self.beta_h)


def _fixed_base_powers(base, tau: int, n: int) -> list:
    """[tau^i * base for i in 0..n) via 8-bit windowed fixed-base tables."""
    window = 8
    windows = (255 + window - 1) // window
    # table[w][d] = d * 2^(8w) * base  (d in 0..256)
    tables = []
    cur = bls._jac_from_affine(base)
    for _ in range(windows):
        row = [(1, 1, 0)]
        for d in range(1, 1 << window):
            row.append(bls._jac_add(row[-1], cur))
        tables.append(row)
        for _ in range(window):
            cur = bls._jac_double(cur)

    out = []
    scalar = 1
    for _ in range(n):
        acc = (1, 1, 0)
        s = scalar
        w = 0
        while s:
            d = s & 0xFF
            if d:
                acc = bls._jac_add(acc, tables[w][d])
            s >>= window
            w += 1
        out.append(bls._jac_to_affine(acc))
        scalar = scalar * tau % R_MOD
    return out
