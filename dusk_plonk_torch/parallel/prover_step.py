"""Mesh-sharded proving pieces: the two-phase scans and the
point-partitioned MSMs.

Counterpart of dusk_plonk_tpu/parallel/prover_step.py, over the port's
one-process mesh (parallel/mesh.py: a sharded value is a list of D
tensors, shard j on devices[j]):

* the grand product (the reference's serial src/permutation.rs:281-295)
  runs in two phases: a per-shard prefix product (`LimbField.prefix_mul`,
  kernel K1), then an all-gather of the D shard totals and an exclusive
  scan of them; the batch inversion builds on it;
* MSM point partitioning: each shard accumulates its block of the points
  and the per-shard partials are gathered to the lead device and summed
  there with kernel K9.

Two local MSM tiers share that structure:

* `msm_point_partitioned`: the port's Pippenger (ops/msm.py) on each
  shard (kernels K11a, K4, K9, K11b, K7), the W window totals summed over
  shards with K9 and combined with K8.  (The JAX function sends shards
  below `msm_serial_max` points to the bit-serial tier; the port's
  MsmPlan has no such tier, so it does not.)
* `msm_bit_serial`: MSB-first double-and-add with every step one complete
  add (kernel K9), the JAX package's compile-lean tier.

`sharded_prover_step` strings one of each together on tiny shapes, as the
JAX function does.

Every function counts `collective_ops` / `collective_bytes` where and as
the JAX function does.
"""

from __future__ import annotations

import math

import torch

from ..ops.ec import device_g1
from ..ops.limb import fr_field
from ..ops.msm import MsmPlan
from ..utils.tracing import tracer
from . import mesh as M
from .ntt import distributed_ntt


def _scan_reduce(G1, pts):
    """Sum points ((R, 24, lanes),)*3 along axis 0 -> ((24, lanes),)*3,
    by halving: ceil(log2 R) complete adds (K9), each over half the rows.
    (The JAX function scans the rows one by one, which keeps one add in
    its compiled graph; eagerly, the halving makes fewer launches.  The
    sum is the same group element.)"""
    while pts[0].shape[0] > 1:
        half = pts[0].shape[0] // 2
        s = G1.add(tuple(c[:half] for c in pts),
                   tuple(c[half:2 * half] for c in pts))
        pts = tuple(torch.cat([a, c[2 * half:]]) for a, c in zip(s, pts))
    return tuple(c[0] for c in pts)


def _local_window_totals(plan, px, py, limbs):
    """One shard's Pippenger window totals ((24, W),)*3, LSB window
    first.  MsmPlan.window_totals pads the scalars with zeros to n_pad,
    so the digits cover the element-major table's padded length (its
    generator pads land in bucket 0, which the reduction drops)."""
    em = plan.prepare_points((px, py, None))
    return plan.window_totals(em, limbs[None])


def msm_point_partitioned(mesh: M.Mesh, axis: str, points, scalar_limbs):
    """Point-partitioned Pippenger over mesh[axis].

    points ((24, N),)*3 strictly affine and scalar_limbs (16, N)
    canonical, each sharded; each shard's W window totals are gathered
    to the lead device, summed over shards (K9) and combined MSB window
    first (K8).  Returns one projective point ((24, 1),)*3 on the lead
    device."""
    d = mesh.shape[axis]
    plan = MsmPlan(points[0][0].shape[-1])              # n_local points
    tracer.count("collective_ops", 3)
    tracer.count("collective_bytes",
                 3 * plan.num_windows * 24 * 4 * (d - 1) * d)
    tots = [_local_window_totals(plan, px, py, s)
            for (px, py, _), s in zip(zip(*points), scalar_limbs)]
    return sum_and_combine(mesh, plan, tots, 1)


def sum_and_combine(mesh: M.Mesh, plan, tots, B: int):
    """Per-shard LSB-first window totals ((24, B * W),)*3, commit-major
    -> gathered to the lead device, summed over shards (K9), then each
    commit's windows combined MSB first (K8, one lane a commit): ((24,
    B),)*3 on the lead device."""
    G1 = device_g1()
    summed = _scan_reduce(G1, tuple(
        torch.stack([t[i].to(mesh.lead, non_blocking=True) for t in tots])
        for i in range(3)))                               # (24, B*W)
    msb = tuple(c.reshape(24, B, plan.num_windows).flip(-1)
                .permute(2, 0, 1).contiguous() for c in summed)  # (W, 24, B)
    return G1.combine(msb, plan.window_bits)


def msm_bit_serial(mesh: M.Mesh, axis: str, points, scalar_limbs,
                   bits: int = 256):
    """Point-partitioned MSM, the JAX package's compile-lean tier
    (`bit_serial_batch` of one commit).  points ((24, N),)*3 and
    scalar_limbs (16, N) each sharded; returns ((24, 1),)*3 on the lead
    device."""
    return bit_serial_batch(mesh, list(zip(*points)),
                            [s[None] for s in scalar_limbs], bits)


def bit_serial_batch(mesh: M.Mesh, points, limbs_stack, bits: int = 256):
    """B MSMs over sharded points, bit-serial: points per shard a ((24,
    nl),)*3 triple, limbs_stack per shard (B, 16, nl) canonical.  Each
    shard runs the double-and-add on B * nl lanes (the commits side by
    side, `_bit_serial_lanes`); the lane partials are gathered to the lead
    device and summed by halving (K9).  Returns ((24, B),)*3 there."""
    B, _, nl = limbs_stack[0].shape
    tiled = [tuple(c.repeat(1, B) for c in p3)            # lane g nl + i
             for p3 in points]
    flat = [lim.permute(1, 0, 2).reshape(16, B * nl) for lim in limbs_stack]
    parts = _bit_serial_lanes(mesh, tiled, flat, bits)
    rows = tuple(
        torch.stack([p[i].to(mesh.lead, non_blocking=True).reshape(24, B, nl)
                     for p in parts])                     # (D, 24, B, nl)
        .permute(0, 3, 1, 2).reshape(-1, 24, B).contiguous()
        for i in range(3))                                # (D*nl, 24, B)
    return _scan_reduce(device_g1(), rows)


def _bit_serial_lanes(mesh: M.Mesh, points, limbs, bits: int = 256):
    """Per shard j and lane i, sum_b bit_b(s_i) 2^b P_i, MSB first, every
    step a complete add (K9): acc + acc, then acc + (P or the identity by
    the bit), as the JAX tier steps.  points: per shard a ((24, lanes),)*3
    triple; limbs: per shard (16, lanes) canonical.  Shards that share a
    device run as one loop over their lanes side by side (the same adds,
    a D-th of the launches on a one-card mesh)."""
    G1 = device_g1()
    groups: dict = {}
    for j, d in enumerate(mesh.devices):
        groups.setdefault(d, []).append(j)
    out = [None] * mesh.size
    for d, js in groups.items():
        p3 = tuple(torch.cat([points[j][i] for j in js], dim=-1)
                   for i in range(3))
        lim = torch.cat([limbs[j] for j in js], dim=-1)
        ident = G1.broadcast_identity((), lim.shape[-1], d)
        acc = ident
        for b in range(bits - 1, -1, -1):
            acc = G1.add(acc, acc)
            bit = ((lim[b // 16] >> (b % 16)) & 1) == 1
            acc = G1.add(acc, G1.select(bit, p3, ident))
        start = 0
        for j in js:
            w = limbs[j].shape[-1]
            out[j] = tuple(c[:, start:start + w] for c in acc)
            start += w
    return out


def grand_product_sharded(mesh: M.Mesh, axis: str, ratio):
    """Inclusive prefix product of ratio (..., L, n), sharded on the
    element axis: a per-shard prefix product, then an all-gather of the D
    shard totals and, on each shard, the product of the totals before it
    (the exclusive scan) as its offset."""
    F = fr_field()
    d = mesh.shape[axis]
    tracer.count("collective_ops", 1)
    # the all-gather of one (..., L, 1) shard total a shard
    tracer.count("collective_bytes",
                 math.prod(ratio[0].shape[:-1]) * 4 * (d - 1) * d)
    local = [F.prefix_mul(r) for r in ratio]
    alltot = M.all_gather(mesh, [x[..., -1:] for x in local])
    out = []
    for j, x, tots in zip(M.axis_index(mesh), local, alltot):
        off = None
        for i in range(j):
            off = tots[i] if off is None else F.mul(off, tots[i])
        out.append(x if off is None else F.mul(x, off))
    return out


def batch_inv_sharded(mesh: M.Mesh, axis: str, F, a):
    """Montgomery's trick over the sharded element axis: prefix and
    suffix products by the two-phase scan, one Fermat inverse of the
    total (on the last shard, then copied to all), 3N multiplications.
    Zero entries map to zero."""
    zeros = [(x == 0).all(dim=-2, keepdim=True) for x in a]
    safe = [torch.where(z, F.const("one_mont", x.device), x)
            for z, x in zip(zeros, a)]
    prefix = grand_product_sharded(mesh, axis, safe)
    suffix = M.flip(mesh, grand_product_sharded(mesh, axis,
                                                 M.flip(mesh, safe)))
    total_inv = M.broadcast(mesh, F.inv(prefix[-1][..., -1:]))
    before = M.prev_halo(mesh, prefix, 1)       # prefix[i - 1]
    after = M.next_halo(mesh, suffix, 1)        # suffix[i + 1]
    d = len(a)
    out = []
    for j, x, p, s, pb, sa, ti, z in zip(
            M.axis_index(mesh), a, prefix, suffix, before, after,
            total_inv, zeros):
        one = F.const("one_mont", x.device).expand(pb.shape)
        pe = torch.cat([one if j == 0 else pb, p[..., :-1]], dim=-1)
        se = torch.cat([s[..., 1:], one if j == d - 1 else sa], dim=-1)
        y = F.mul(F.mul(pe, se), ti)
        out.append(torch.where(z, torch.zeros_like(x), y))
    return out


def sharded_prover_step(mesh: M.Mesh, k: int, args):
    """One mesh-sharded proving macro-step on tiny shapes, as the JAX
    function: iNTT then coset DFT (distributed) | a quotient-style
    elementwise step with the next-element wraparound, then the grand
    product | a 32-bit bit-serial point-partitioned MSM.

    args = (wires (B, 16, n) Montgomery, points ((24, N),)*3 affine,
    scalars (16, N) canonical), each one tensor; returns (z (16, n) on the
    lead device, the commitment ((24, 1),)*3 on the lead device)."""
    wires, points, scalars = args
    F = fr_field()
    axis = mesh.axis
    wires = M.shard(mesh, wires)
    points = tuple(M.shard(mesh, c) for c in points)
    scalars = M.shard(mesh, scalars)

    polys = distributed_ntt(mesh, axis, wires, k, "idft")
    evals = distributed_ntt(mesh, axis, polys, k, "coset_dft")
    halo = M.next_halo(mesh, evals, 1)
    ratio = []
    for e, h in zip(evals, halo):
        nxt = torch.cat([e[..., 1:], h], dim=-1)
        t = F.mul(F.add(e, nxt), e)
        ratio.append(F.add(t[0], F.const("one_mont", e.device)))
    z = grand_product_sharded(mesh, axis, ratio)
    commit = msm_bit_serial(mesh, axis, points, scalars, bits=32)
    return M.gather(mesh, z), commit
