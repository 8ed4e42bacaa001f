"""Point-partitioned MSM over a device mesh.

Counterpart of dusk_plonk_tpu/parallel/msm.py::ShardedMsm.  The SRS
points are sharded over the mesh (parallel/mesh.py) and each shard
accumulates only its block; per commit batch the per-shard partials are
gathered to the lead device and summed there.  Both local tiers give the
same group elements:

* ``pippenger``: each shard runs the port's Pippenger (ops/msm.py) over
  its n / D points in its own MsmPlan(n / D), row groups and all (K11a,
  K4, K9, K11b, K7); the (B * W) window totals of the D shards are
  gathered to the lead device and summed over shards with K9 (log2 D
  halving launches); then each commit's W windows are combined on the
  device with K8, one lane a commit, as the JAX tier combines them (JAX
  parallel/msm.py:113-119).
* ``bit_serial``: MSB-first double-and-add on each shard, every step a
  complete add (K9); the (B * n / D) lane partials are gathered and summed
  by halving (K9).

The result's conversion to affine runs on the host (a Python inverse of Z
a commit), as the single-device path converts on the host
(ops/msm.py::MsmPlan.msm_affine_batch); the affine point is unique, so
the route does not show in any commitment.  The JAX tier's device Fermat
inverse would be ~450 one-element K1 launches a batch.

The JAX class pads every batch to ``GROUP = 4`` commits so that XLA
compiles one executable shape; the port runs eagerly, and the padding
would only multiply the work of a single commit by four, so a batch runs
as it comes.
"""

from __future__ import annotations

import torch

from ..ops.limb import fq_field
from ..ops.msm import MsmPlan
from ..utils.tracing import tracer
from . import mesh as M
from .prover_step import bit_serial_batch, sum_and_combine


class ShardedMsm:
    """MSM engine over mesh[axis]-sharded points: `prepare_points(points)`
    once for the SRS, then `msm_affine_batch(prepared, limbs_stack)` per
    commit batch, mirroring ops/msm.py::MsmPlan."""

    def __init__(self, mesh: M.Mesh, axis: str, n: int,
                 tier: str = "pippenger"):
        d = mesh.shape[axis]
        if n % d:
            raise ValueError(f"SRS length {n} must divide over {d} shards")
        if tier not in ("pippenger", "bit_serial"):
            raise ValueError(f"unknown MSM tier {tier!r}")
        self.mesh = mesh
        self.d = d
        self.n = n
        self.n_local = n // d
        self.tier = tier
        self.Fq = fq_field()
        self.plan = MsmPlan(self.n_local) if tier == "pippenger" else None

    def prepare_points(self, points):
        """points ((24, n),)*3 strictly affine, each sharded -> per shard
        the element-major table (pippenger) or the point planes."""
        shards = list(zip(*points))
        if self.plan is None:
            return shards
        return [self.plan.prepare_points(p) for p in shards]

    def msm_affine_batch(self, prepared, limbs_stack):
        """limbs_stack (B, 16, n) canonical scalar limbs, sharded -> B
        affine host points ((x, y) ints, or None for the identity)."""
        B = limbs_stack[0].shape[0]
        tracer.count("msm_dispatch")
        tracer.count("msm_points", self.n * B)
        # the gathered per-shard window partials, as the JAX tier counts
        # them
        w = self.plan.num_windows if self.plan is not None else 1
        tracer.count("collective_ops", 3)
        tracer.count("collective_bytes",
                     3 * B * w * 24 * 4 * (self.d - 1) * self.d)
        if self.plan is None:
            X, Y, Z = bit_serial_batch(self.mesh, prepared, limbs_stack)
        else:
            tots = [self.plan.window_totals(em, lim)     # (24, B * W)
                    for em, lim in zip(prepared, limbs_stack)]
            X, Y, Z = sum_and_combine(self.mesh, self.plan, tots, B)
        vals = self.Fq.unpack(torch.stack([X, Y, Z]), from_mont=False)
        q = self.Fq.spec.modulus
        out = []
        for x, y, z in zip(vals[:B], vals[B:2 * B], vals[2 * B:]):
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, -1, q)                # Montgomery factors cancel
                out.append((x * zi % q, y * zi % q))
        return out
