"""Mesh-sharded proving engine: the 5-round prover over a device mesh.

Counterpart of dusk_plonk_tpu/proving/sharded_engine.py.  One mesh axis
(parallel/mesh.py, one process driving D shards) shards the evaluation
domain, and the hot components run distributed:

* every n- and 8n-domain transform: the four-step distributed NTT, two
  collectives a transform (parallel/ntt.py);
* the grand product and the batch inversion: the two-phase scans
  (parallel/prover_step.py);
* every commitment: the point-partitioned MSM over the sharded SRS, its
  window totals summed over shards and combined on the device with K8
  (parallel/msm.py);
* round 2's products and round 3's quotient grid run shard by shard on
  the sharded tables, the grid one K14 launch a shard; the quotient's
  next-gate wraparound (the reference's 8-element append,
  src/prover/quotient_poly.rs:60-66) reads each shard's own columns and,
  past its end, `next_halo(x, 8)`, the boundary permute XLA derives from
  `jnp.roll` in the JAX engine.

Where the JAX engine leaves a step to GSPMD and the step is not
elementwise (the evaluations at z, the linearisation polynomial,
round 3's chunking and the openings' synthetic division), this engine
gathers the (..., 16, nsd) vectors to the lead device and runs
TorchEngine's code there (`_whole`); those gathers count `gather_bytes`,
apart from the model's `collective_bytes`.  The re-layouts between the
n, nsd and 8n widths, which GSPMD makes in the JAX engine, count
`relayout_bytes`.

The selector and sigma polynomials stay whole on the lead device: only
those gathered steps read them, so sharding them would add a gather of 15
polynomials a proof.

Transcript, RNG draw order and device arithmetic are TorchEngine's, and
the arithmetic is exact, so the proofs are byte for byte those of the
single-device engine and the host oracle
(tests/test_torch_sharded_engine*.py).  ``msm_tier="bit_serial"`` swaps
the per-shard Pippenger for the double-and-add tier (the same group
elements).
"""

from __future__ import annotations

import torch

from ..parallel import mesh as M
from ..parallel.mesh import default_mesh
from ..parallel.msm import ShardedMsm
from ..parallel.ntt import dist_ntt_plan, distributed_ntt
from ..parallel.prover_step import batch_inv_sharded, grand_product_sharded
from ..ops import kernels
from .engine import TorchEngine


class ShardedEngine(TorchEngine):
    """TorchEngine with every domain axis sharded over mesh[axis]; the
    lead device (mesh.devices[0]) holds what runs whole.  Keyword
    arguments go to TorchEngine (sel_polys, sigma_polys, srs, wire_plan;
    a single-device msm / srs_em is not used)."""

    def __init__(self, prover, mesh: M.Mesh | None = None,
                 axis: str | None = None, msm_tier: str = "pippenger",
                 **kw):
        self.mesh = mesh if mesh is not None else default_mesh(axis)
        self.axis = axis or self.mesh.axis
        self.D = self.mesh.shape[self.axis]
        self.msm_tier = msm_tier
        super().__init__(prover, self.mesh.lead, **kw)

    # -- hook overrides ------------------------------------------------------

    def _device_width(self, ns: int) -> int:
        return -(-ns // self.D) * self.D

    def _make_msm(self, msm, srs_em):
        return None, None               # _stage_tables builds the ShardedMsm

    def _stage_tables(self):
        mesh = self.mesh
        for key in ("sel8", "sig8", "l1_8", "lin8", "vh_inv8", "roots_n",
                    "sigma_evals_n"):
            setattr(self, key, M.shard(mesh, getattr(self, key)))
        self.ks = M.broadcast(mesh, self.ks)
        # pad the SRS to the device width with generator points (always
        # zero coefficients: they add nothing to a commitment, and keep
        # every lane strictly affine for the mixed-add scan), then shard
        srs = self.srs
        if self.nsd != self.ns:
            gx, gy = self.G1.generator_affine(self.device)
            one = self.G1.identity(self.device)[1]       # Montgomery 1
            pad = self.nsd - self.ns
            srs = tuple(torch.cat([c, p.expand(24, pad)], dim=-1)
                        for c, p in zip(srs, (gx, gy, one)))
        self.smsm = ShardedMsm(mesh, self.axis, self.nsd, self.msm_tier)
        self.srs_sh = self.smsm.prepare_points(
            tuple(M.shard(mesh, c) for c in srs))
        for k in (self.k, self.k8):
            if (1 << k) % (self.D * self.D) == 0:
                dist_ntt_plan(mesh, k)

    def _t_n(self, x, kind):
        return distributed_ntt(self.mesh, self.axis, x, self.k, kind)

    def _t_8n(self, x, kind):
        return distributed_ntt(self.mesh, self.axis, x, self.k8, kind)

    def _prefix_mul(self, x):
        return grand_product_sharded(self.mesh, self.axis, x)

    def _batch_inv(self, x):
        return batch_inv_sharded(self.mesh, self.axis, self.F, x)

    def _stage_dom(self, x):
        return M.shard(self.mesh, x)

    def _whole(self, x):
        return M.gather(self.mesh, x)

    def _commit_batch(self, canon_stack):
        """(B, 16, nsd) canonical coefficients, sharded or whole on the
        lead device (the steps that run whole) -> B affine points."""
        if isinstance(canon_stack, torch.Tensor):
            canon_stack = M.shard(self.mesh, canon_stack)
        return self.smsm.msm_affine_batch(self.srs_sh, canon_stack)

    # -- rounds, shard by shard ----------------------------------------------

    def _blind_into(self, poly, blinders, width):
        """As TorchEngine._blind_into on a sharded poly: re-laid out to
        `width`, then each blinder added into the shard that holds its
        coefficient."""
        F, n = self.F, self.n
        buf = M.relayout(self.mesh, poly, width)
        w = width // self.D
        for i in range(blinders.shape[-1]):
            for pos, op in ((n + i, F.add), (i, F.sub)):
                j, o = divmod(pos, w)
                b = blinders[..., i:i + 1].to(buf[j].device)
                buf[j][..., o:o + 1] = op(buf[j][..., o:o + 1], b)
        return buf

    def _round1(self, wire_vals, blinders):
        polys = self._t_n(wire_vals, "idft")
        bufs = self._blind_into(polys, blinders, self.nsd)
        return bufs, [self.F.from_mont(b) for b in bufs]

    def _round2(self, wire_vals, beta, gamma, blinders):
        F, mesh = self.F, self.mesh
        parts = [self._perm_products(*args) for args in zip(
            wire_vals, self.roots_n, self.sigma_evals_n, self.ks,
            M.broadcast(mesh, beta), M.broadcast(mesh, gamma))]
        dinv = self._batch_inv([d for _, d in parts])
        ratio = [F.mul(nprod, di) for (nprod, _), di in zip(parts, dinv)]
        incl = self._prefix_mul(ratio)
        # z = (1, incl[0], ..., incl[n - 2]): each shard's first element
        # is the previous shard's last
        z = []
        for j, x, prev in zip(M.axis_index(mesh), incl,
                              M.prev_halo(mesh, incl, 1)):
            if j == 0:
                prev = F.const("one_mont", x.device)
            z.append(torch.cat([prev, x[..., :-1]], dim=-1))
        z_poly = self._t_n(z, "idft")
        buf = self._blind_into(z_poly, blinders, self.nsd)
        return buf, [F.from_mont(b[None]) for b in buf]

    def _round3_decomposed(self, wire_polys, z_poly, pi_dense, consts):
        mesh, n8 = self.mesh, self.n8
        pi_poly = self._t_n(pi_dense, "idft")
        rows = zip(M.relayout(mesh, [z[None] for z in z_poly], n8),
                   M.relayout(mesh, wire_polys, n8),
                   M.relayout(mesh, [p[None] for p in pi_poly], n8))
        evs = self._t_8n([torch.cat(r) for r in rows], "coset_dft")
        # z, a, b, d at the next gate, roll(x, -8) over the whole coset:
        # past a shard's end, the next shard's first 8 points
        halos = M.next_halo(mesh, [e[[0, 1, 2, 4], :, :8].contiguous()
                                   for e in evs], 8)
        cs = M.broadcast(mesh, consts)
        t = [kernels.quotient(self.F, evs[j], halos[j].contiguous(),
                              self.sel8[j], self.sig8[j], self.l1_8[j],
                              self.lin8[j], self.vh_inv8[j], cs[j])
             for j in M.axis_index(mesh)]
        return self._t_8n(t, "coset_idft")
