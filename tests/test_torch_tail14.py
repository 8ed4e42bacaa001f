"""The JAX package's 14-bit tail kernels K7 (pf.ec_double_add14) and K8
(pf.ec_combine14) against the port's K7 (ec_double_add) and K8
(ec_combine), through the plain versions on the CPU, in affine form (the
14-bit engine's outputs are the same points scaled by 2^8).  Inputs are
made from a seed with numpy, with identity lanes."""

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


def _steps(seed, steps):
    """((steps, 24, lanes),)*3 Montgomery projective limbs with random Z;
    lane 0 of step 0 and lane 1 of the last step are O, and step 1 of lane
    2 is minus step 0's point."""
    rng = np.random.default_rng(seed)
    pool = [bls.g1_mul(bls.G1_GENERATOR, int(s))
            for s in rng.integers(1, 1 << 62, size=16)]
    pts = [[pool[i] for i in rng.integers(0, 16, size=LANES)]
           for _ in range(steps)]
    pts[0][0] = None
    pts[-1][1] = None
    pts[1][2] = bls.g1_neg(pts[0][2])
    cols = ([], [], [])
    for p in (p for row in pts for p in row):
        z = int.from_bytes(rng.bytes(48), "little") % (Q - 1) + 1
        v = (0, 1, 0) if p is None else (p[0] * z % Q, p[1] * z % Q, z)
        for c, x in zip(cols, v):
            c.append(x)
    return tuple(F.pack(c, "cpu", shape=(steps, LANES)) for c in cols)


def _affine(pts):
    X, Y, Z = (F.unpack(c, from_mont=False) for c in pts)
    return [(x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q) if z else None
            for x, y, z in zip(X, Y, Z)]


def _stacked(g):
    return jnp.asarray(torch.cat(g, dim=-2).numpy().astype(np.uint32))


def _split(st):
    a = torch.from_numpy(np.asarray(st).astype(np.int32))
    return tuple(a[..., i * 24:(i + 1) * 24, :] for i in range(3))


def test_ec_double_add_plain_matches_ec_double_add14():
    g = _steps(41, 2)
    a, b = (tuple(c[s] for c in g) for s in (0, 1))
    got = _affine(kernels.ec_double_add(G1, a, b, 3))
    want = _affine(_split(pf.ec_double_add14(
        _stacked(a), _stacked(b), 3, interpret=True)))
    assert got == want
    assert got[1] is not None and got[0] is not None


def test_ec_combine_plain_matches_ec_combine14():
    g = _steps(42, 3)
    got = _affine(kernels.ec_combine(G1, g, 2))
    assert got == _affine(_split(pf.ec_combine14(_stacked(g), 2,
                                                 interpret=True)))
