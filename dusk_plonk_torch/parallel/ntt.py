"""Distributed four-step NTT over a device mesh.

Counterpart of dusk_plonk_tpu/parallel/ntt.py.  With n = D * n2 over D
shards (k = k2 + n2 * k1, j = j1 + D * j2):

  X[k2 + n2 k1] = sum_j1 W2^(j1 k1) [ w^(j1 k2) * sum_j2 W1^(j2 k2) x[j1 + D j2] ]

  1. ALL-TO-ALL: contiguous shards -> shard j1 holds the stride-D
     subsequence x[j1 + D j2], ordered by j2;
  2. the inner size-n2 NTT of that row on the shard's device (W1 = w^D):
     the port's NttPlan, kernel K2;
  3. the mid twiddle w^(j1 k2) (kernel K1);
  4. ALL-GATHER and a weighted sum: shard k1 computes
     sum_j1 C[j1] W2^(j1 k1) (W2 = w^n2, a D-point DFT across shards)
     with one K1 launch and `LimbField.sum_reduce`.  The output lands
     contiguously sharded, in natural order.

Exactly two collectives a transform.  The four kinds (dft, idft,
coset_dft, coset_idft) share one plan and differ only in table values
(w or w^-1, the pre and post scales).  Domains with n % D^2 != 0 (the
restripe needs D | n2) take the single-plan fallback: gather, transform
with NttPlan on the lead device, re-shard.
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.constants import R_MOD, FR_GENERATOR
from ..fields.host import fr_root_of_unity
from ..ops.limb import fr_field
from ..ops.ntt import NttPlan
from ..utils.tracing import tracer
from . import mesh as M


@lru_cache(maxsize=None)
def _plan(k: int, device) -> NttPlan:
    return NttPlan(k, device)


class DistNttPlan:
    """Tables for one (mesh, domain 2^k) pair, each shard's on its
    device: `tables(kind)[j]` is shard j's dict of inner NttPlan and
    steps, mid twiddle, outer weights (D, 16, 1) and pre / post scales
    (None: a scale of one, no multiply)."""

    def __init__(self, mesh: M.Mesh, k: int):
        d = mesh.size
        if d & (d - 1) or (1 << k) % d:
            raise ValueError(f"four-step NTT: 2^{k} over {d} shards")
        self.d = d
        self.k = k
        self.n = n = 1 << k
        self.n2 = n2 = n // d
        self.k2 = n2.bit_length() - 1
        F = self.F = fr_field()
        w = fr_root_of_unity(k)
        w_inv = pow(w, -1, R_MOD)
        n_inv = pow(n, -1, R_MOD)
        g = FR_GENERATOR
        g_inv = pow(g, -1, R_MOD)
        self._tabs = {kind: [] for kind in
                      ("dft", "idft", "coset_dft", "coset_idft")}
        for j, dev in enumerate(mesh.devices):
            inner = _plan(self.k2, dev)

            def mid(root):
                # w^(j1 k2) over this shard's row; all ones on shard 0
                return None if j == 0 else \
                    F.powers_host_base(pow(root, j, R_MOD), n2, dev)

            def outer(root):
                w2 = pow(root, n2, R_MOD)
                return F.pack([pow(w2, (j1 * j) % n, R_MOD)
                               for j1 in range(d)], dev, shape=(d, 1))

            fwd = dict(inner=inner, steps=inner._tables(False),
                       mid=mid(w), outer=outer(w), pre=None, post=None)
            inv = dict(inner=inner, steps=inner._tables(True),
                       mid=mid(w_inv), outer=outer(w_inv), pre=None,
                       post=F.pack([n_inv], dev))
            # coset scales over this shard's block of the CONTIGUOUS
            # layout: g^i before (fwd), g^-i / n after (inv)
            base = j * n2
            coset = F.powers_host_base(g, n2, dev, scale=pow(g, base, R_MOD))
            coset_inv = F.powers_host_base(
                g_inv, n2, dev, scale=pow(g_inv, base, R_MOD) * n_inv % R_MOD)
            self._tabs["dft"].append(fwd)
            self._tabs["idft"].append(inv)
            self._tabs["coset_dft"].append(dict(fwd, pre=coset))
            self._tabs["coset_idft"].append(dict(inv, post=coset_inv))

    def tables(self, kind: str):
        return self._tabs[kind]


@lru_cache(maxsize=None)
def dist_ntt_plan(mesh: M.Mesh, k: int) -> DistNttPlan:
    return DistNttPlan(mesh, k)


def distributed_ntt(mesh: M.Mesh, axis: str, xs, k: int, kind: str = "dft"):
    """xs: (L, n) or (B, L, n) sharded contiguously on the element axis
    over mesh[axis] (a list of D tensors); returns the transform, sharded
    the same way, natural order."""
    d = mesh.shape[axis]
    if (1 << k) % (d * d):
        x = M.gather(mesh, xs)
        return M.shard(mesh, getattr(_plan(k, mesh.lead), kind)(x))
    plan = dist_ntt_plan(mesh, k)
    F, n2 = plan.F, plan.n2
    tabs = plan.tables(kind)
    # collective traffic, as the JAX package counts it: the all-to-all
    # moves (D-1)/D of the array once; the all-gather delivers (D-1)/D of
    # it to each of D shards
    nbytes = sum(x.numel() * 4 for x in xs)
    tracer.count("collective_ops", 2)
    tracer.count("collective_bytes",
                 nbytes * (d - 1) // d + nbytes * (d - 1))
    lead = xs[0].shape[:-2]
    xs = [x if t["pre"] is None else F.mul(x, t["pre"])
          for x, t in zip(xs, tabs)]
    # ALL-TO-ALL: element j n2 + u D + v of shard j goes to shard v at
    # position j (n2 / D) + u
    parts = M.all_to_all(
        mesh, [x.reshape(lead + (F.L, n2 // d, d)) for x in xs],
        split_axis=-1, concat_axis=-2)
    rows = []
    for p, t in zip(parts, tabs):
        row = t["inner"]._transform(p.reshape(lead + (F.L, n2)), t["steps"],
                                    None, None)
        rows.append(row if t["mid"] is None else F.mul(row, t["mid"]))
    # ALL-GATHER, then shard k1's weighted sum over j1 (one K1 launch:
    # the weights are made (D, ..., L, 1) so its rows fold)
    out = []
    for allrows, t in zip(M.all_gather(mesh, rows), tabs):
        wts = t["outer"].reshape((d,) + (1,) * len(lead) + (F.L, 1)) \
            .expand((d,) + lead + (F.L, 1)).contiguous()
        y = F.sum_reduce(F.mul(allrows, wts), axis=0)
        out.append(y if t["post"] is None else F.mul(y, t["post"]))
    return out
