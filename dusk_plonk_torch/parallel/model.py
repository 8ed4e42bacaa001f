"""Analytic scaling model of the mesh-sharded prover.

Counterpart of dusk_plonk_tpu/parallel/model.py, with the same functions
and formulas and the card's own constants.  One card shows no scaling:
every shard of a one-card mesh shares one device, and the collectives are
device-local copies.  So the projection over D cards rests on

1. the per-proof collective traffic counted by the tracer at every
   collective call site (`collective_bytes` / `collective_ops`:
   parallel/ntt.py, parallel/msm.py, parallel/prover_step.py);
2. this closed-form traffic model, held against those counters
   (tests/test_torch_scaling_model.py); the formula does not depend on
   the backend, so it equals the JAX package's;
3. single-card compute rates measured by chip_smoke.py, to turn traffic
   into projected step time over the links.

The defaults (NVIDIA H100 80GB HBM3 at a 700 W power limit):
* `link_gbps`: NVLink 4 of the H100 SXM, 450 GB/s each way to the other
  cards of the host (NVIDIA's published figure, 900 GB/s both ways; not
  measured: one card has no link);
* `msm_pts_per_s`: `MsmPlan.msm_device` on 2^16 points in 8.985 ms,
  7,293,906 points/s (chip_smoke.py phase `msm`, best of 3);
* `ntt_elems_per_s`: kernel K2's (6, 16, 2^19) coset DFT in 0.9856 ms,
  3.192e9 elements/s (chip_smoke.py phase `kernels`, the same run).
"""

from __future__ import annotations

from dataclasses import dataclass

FR_BYTES = 16 * 4          # one Fr element: 16 limbs of 4 bytes
G1_BYTES = 3 * 24 * 4      # a projective Montgomery G1 point


@dataclass(frozen=True)
class MeshModel:
    link_gbps: float = 450.0          # NVLink 4 GB/s each way (published)
    msm_pts_per_s: float = 7.294e6    # msm_device at 2^16 (chip_smoke.py)
    ntt_elems_per_s: float = 3.192e9  # K2, (6, 16, 2^19) (chip_smoke.py)


def proof_collective_bytes(k: int, d: int) -> dict:
    """Per-proof collective traffic of the ShardedEngine at domain 2^k
    over D devices, from the engine's round structure:

    distributed NTTs: round1 idft (4, n); round2 idft (1, n); round3 pi
    idft (1, n), the coset DFT of six polynomials counted as three pairs
    (2, 8n) x 3, and the coset iDFT of t (1, 8n); each four-step
    transform does one all-to-all ((D-1)/D of the array crosses links)
    and one all-gather ((D-1) copies), as the tracer counts them.

    MSM commits: 11 a proof, each gathering 3 coordinate planes of W
    window totals a device.  Grand-product scans: the all-gather of one
    (L, 1) total a device (negligible, counted for completeness)."""
    n = 1 << k
    n8 = 8 * n
    transforms = [4 * n, 1 * n, 1 * n, 2 * n8, 2 * n8, 2 * n8, 1 * n8]
    a2a = sum(t * FR_BYTES * (d - 1) // d for t in transforms)
    ag = sum(t * FR_BYTES * (d - 1) for t in transforms)
    w = max(2, min(13, n.bit_length() - 1 - 4))          # pick_window_bits
    num_windows = -(-257 // w)
    msm = 11 * 3 * num_windows * 24 * 4 * (d - 1) * d
    scans = 3 * 16 * 4 * (d - 1) * d                      # 3 sharded scans
    return {
        "ntt_all_to_all": a2a,
        "ntt_all_gather": ag,
        "msm_window_gather": msm,
        "scan_gather": scans,
        "total": a2a + ag + msm + scans,
    }


def projected_efficiency(k: int, d: int,
                         m: MeshModel = MeshModel()) -> dict:
    """Projected parallel efficiency of one sharded proof at 2^k over D
    cards: T_compute / D against the collective time at the link rate.
    Compute time from the single-card rates over the proof's op counts
    (11 n-point commits; 6 n-domain and 7 8n-domain transform rows)."""
    n = 1 << k
    msm_points = 11 * n
    ntt_elems = 6 * n + 7 * 8 * n
    t_compute = msm_points / m.msm_pts_per_s + ntt_elems / m.ntt_elems_per_s
    traffic = proof_collective_bytes(k, d)
    t_comm = traffic["total"] / d / (m.link_gbps * 1e9)
    t_d = t_compute / d + t_comm
    eff = (t_compute / d) / t_d
    return {
        "k": k, "d": d,
        "compute_s_1chip": round(t_compute, 3),
        "comm_s_per_device": round(t_comm, 4),
        "projected_step_s": round(t_d, 3),
        "efficiency": round(eff, 4),
        "collective_gb": round(traffic["total"] / 1e9, 3),
    }
