"""The merged kernel rows: the JAX package's 14-bit kernels K3
(pf.ec_scan_mixed14) and K5 (pf.ec_add14) against the port's K11a
(ec_scan_mixed) and K9 (ec_add), which replace them, through the plain
versions on the CPU.  The 14-bit engine (R = 2^392) returns projective
triples scaled by 2^8, so outputs are compared in affine form; the 14-bit
scan takes its affine table in Montgomery-R14 form, the port's in R16.
Inputs are made from a seed with numpy."""

import numpy as np
import torch
import jax.numpy as jnp

import dusk_plonk_tpu.ops.pallas_field as pf
from dusk_plonk_tpu.curves import bls
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.ec import device_g1

torch.set_num_threads(1)

G1 = device_g1()
F = G1.F
Q = F.spec.modulus
LANES = 128
R14 = (1 << 392) % Q


def _pool(seed):
    rng = np.random.default_rng(seed)
    return [bls.g1_mul(bls.G1_GENERATOR, int(s))
            for s in rng.integers(1, 1 << 62, size=16)]


def _affine(pts):
    """Projective limbs (any uniform Montgomery scale) -> flat list of
    affine host points; Z = 0 -> None."""
    X, Y, Z = (F.unpack(c, from_mont=False) for c in pts)
    return [(x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q) if z else None
            for x, y, z in zip(X, Y, Z)]


def _limbs(vals):
    buf = b"".join(int(v).to_bytes(48, "little") for v in vals)
    return np.frombuffer(buf, "<u2").reshape(len(vals), 24).T.astype(
        np.int32)


def _from_jax(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def test_ec_scan_mixed_plain_matches_ec_scan_mixed14():
    """K11a (merged row K3): the running sums of affine steps, with a
    P + P and a P + (-P) step."""
    cl = 3
    rng = np.random.default_rng(21)
    pool = _pool(21)
    pts = [[pool[i] for i in rng.integers(0, 16, size=LANES)]
           for _ in range(cl)]
    pts[1][1] = pts[0][1]                                   # P + P
    pts[1][2] = bls.g1_neg(pts[0][2])                       # P + (-P)

    def table(scale):
        rows = []
        for row in pts:
            rows.append(np.concatenate(
                [_limbs([p[0] * scale % Q for p in row]),
                 _limbs([p[1] * scale % Q for p in row])]))
        return np.stack(rows)                               # (cl, 48, lanes)

    ours = kernels.ec_scan_mixed(G1, torch.from_numpy(table(F.spec.mont_r)))
    psc = pf.ec_scan_mixed14(jnp.asarray(table(R14).astype(np.uint32)),
                             interpret=True)
    theirs = (psc[:, :24], psc[:, 24:48], psc[:, 48:])
    for s in range(cl):
        assert _affine(tuple(c[s] for c in ours)) == \
            _affine(tuple(_from_jax(c[s]) for c in theirs)), s
    assert _affine(tuple(c[1] for c in ours))[2] is None


def test_ec_add_plain_matches_ec_add14():
    """K9 (merged row K5): projective operands with random Z, identity,
    P + P and P + (-P) lanes."""
    rng = np.random.default_rng(22)
    pool = _pool(22)
    p = [pool[i] for i in rng.integers(0, 16, size=LANES)]
    q = [pool[i] for i in rng.integers(0, 16, size=LANES)]
    p[0] = None
    q[1] = None
    p[2] = q[2] = None
    q[3] = p[3]
    q[4] = bls.g1_neg(p[4])

    def proj(pts):
        cols = ([], [], [])
        for pt in pts:
            z = int.from_bytes(rng.bytes(48), "little") % (Q - 1) + 1
            v = (0, 1, 0) if pt is None else \
                (pt[0] * z % Q, pt[1] * z % Q, z)
            for c, x in zip(cols, v):
                c.append(x * F.spec.mont_r % Q)
        return tuple(torch.from_numpy(_limbs(c)) for c in cols)

    a, b = proj(p), proj(q)
    ours = kernels.ec_add(G1, a, b)
    st = pf.ec_add14(jnp.asarray(torch.cat(a).numpy().astype(np.uint32)),
                     jnp.asarray(torch.cat(b).numpy().astype(np.uint32)),
                     interpret=True)
    theirs = tuple(_from_jax(st[i * 24:(i + 1) * 24]) for i in range(3))
    got = _affine(ours)
    assert got == _affine(theirs)
    assert got[2] is None and got[4] is None
    assert got[0] == q[0] and got[1] == p[1]
