"""The EC kernels of the JAX package's switched-off configuration, through
the port's plain versions on the CPU: K10 (ec_add_mixed, behind
DeviceG1.add_mixed) against pf.ec_add_mixed and K12 (ec_scan_mixed_em)
against pf.ec_scan_mixed14_em, both in interpret mode.

K10 shares the 16-bit engine with the JAX kernel, so it is compared limb
for limb; K12's JAX counterpart is the 14-bit engine's, whose projective
triples are scaled by 2^8, so it is compared in affine form.  Inputs are
made from a seed with numpy."""

import numpy as np
import torch
import jax.numpy as jnp

import dusk_plonk_tpu.ops.pallas_field as pf
from dusk_plonk_tpu.curves import bls
from dusk_plonk_tpu.utils import config as jax_config
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


def _limbs(vals):
    buf = b"".join(int(v).to_bytes(48, "little") for v in vals)
    return np.frombuffer(buf, "<u2").reshape(len(vals), 24).T.astype(
        np.int32)


def _affine(pts):
    """Projective limbs (any uniform Montgomery scale) -> affine host
    points; Z = 0 -> None."""
    X, Y, Z = (F.unpack(c, from_mont=False) for c in pts)
    return [(x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q) if z else None
            for x, y, z in zip(X, Y, Z)]


def test_ec_add_mixed_plain_matches_jax():
    """Random projective p (random Z) plus affine q, with an identity p,
    p = q and p = -q lanes."""
    rng = np.random.default_rng(31)
    pool = _pool(31)
    p = [pool[i] for i in rng.integers(0, 16, size=LANES)]
    q = [pool[i] for i in rng.integers(0, 16, size=LANES)]
    p[0] = None
    p[1] = q[1]
    p[2] = bls.g1_neg(q[2])
    R = F.spec.mont_r
    cols = ([], [], [])
    for pt in p:
        z = int.from_bytes(rng.bytes(48), "little") % (Q - 1) + 1
        v = (0, 1, 0) if pt is None else (pt[0] * z % Q, pt[1] * z % Q, z)
        for c, x in zip(cols, v):
            c.append(x * R % Q)
    a = tuple(torch.from_numpy(_limbs(c)) for c in cols)
    b = tuple(torch.from_numpy(_limbs([pt[i] * R % Q for pt in q]))
              for i in range(2))
    ours = G1.add_mixed(a, b)
    theirs = pf.ec_add_mixed(
        tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in a),
        tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in b),
        interpret=True)
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(),
                                      np.asarray(t).astype(np.int32))
    got = _affine(ours)
    assert got[0] == q[0]
    assert got[1] == bls.g1_add(q[1], q[1])
    assert got[2] is None


def test_ec_scan_mixed_em_plain_matches_jax():
    """(cl, 48, lanes) = (4, 48, 128) steps, with a P + P and a P + (-P)
    step, against the 14-bit element-major scan in affine form."""
    cl = 4
    rng = np.random.default_rng(32)
    pool = _pool(32)
    pts = [[pool[i] for i in rng.integers(0, 16, size=LANES)]
           for _ in range(cl)]
    pts[1][1] = pts[0][1]
    pts[1][2] = bls.g1_neg(pts[0][2])

    def table(scale):
        return np.stack([np.concatenate(
            [_limbs([p[0] * scale % Q for p in row]),
             _limbs([p[1] * scale % Q for p in row])]) for row in pts])

    ours = kernels.ec_scan_mixed_em(G1, torch.from_numpy(
        table(F.spec.mont_r)))
    assert ours.shape == (cl, LANES, 72)
    # one scan step a Pallas program keeps the interpret-mode compile small
    old = jax_config.get_config().ec_scan_steps
    jax_config.set_config(ec_scan_steps=1)
    try:
        theirs = np.asarray(pf.ec_scan_mixed14_em(
            jnp.asarray(table(R14).astype(np.uint32)), interpret=True))
    finally:
        jax_config.set_config(ec_scan_steps=old)
    for s in range(cl):
        mine = tuple(ours[s, :, 24 * i:24 * (i + 1)].T for i in range(3))
        jax_s = tuple(torch.from_numpy(
            theirs[s, :, 24 * i:24 * (i + 1)].T.astype(np.int32))
            for i in range(3))
        assert _affine(mine) == _affine(jax_s), s
    assert _affine(tuple(ours[1, :, 24 * i:24 * (i + 1)].T
                         for i in range(3)))[2] is None
