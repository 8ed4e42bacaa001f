"""dusk_plonk_torch.ops.ec: kernel K9's plain version against the JAX
DeviceG1._add_xla, and kernel K11a's plain scan against a loop of
DeviceG1._add_mixed_xla, on raw projective limbs (the same RCB15 step order
gives the same canonical coordinates).  Inputs are made from a seed with
numpy; comparisons are exact."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dusk_plonk_tpu.curves import bls
from dusk_plonk_tpu.ops.ec import device_g1 as jax_g1
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.ec import device_g1

torch.set_num_threads(1)

N_POINTS = 16


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(7)
    scalars = [int(s) for s in rng.integers(1, 1 << 62, size=N_POINTS)]
    host = [bls.g1_mul(bls.G1_GENERATOR, s) for s in scalars]
    G1 = device_g1()
    return host, G1.pack_points(host, "cpu")          # z = 1 affine


def _lanes(pts, seed, lanes):
    """Random projective representatives of the table points:
    (x z, y z, z) with seeded random z."""
    rng = np.random.default_rng(seed)
    G1 = device_g1()
    F = G1.F
    idx = torch.from_numpy(rng.integers(0, N_POINTS, size=lanes))
    zs = [int.from_bytes(rng.bytes(47), "little") for _ in range(lanes)]
    z = F.pack(zs, "cpu")
    x, y = pts[1][0][:, idx], pts[1][1][:, idx]
    return (F.mul(x, z), F.mul(y, z), z)


def _jax(a):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in a)


def _eq(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            np.int32))


def _special_lanes(pts, lanes):
    """Operand pairs whose first 15 lanes are P + O, O + Q, O + O, P + P
    and P + (-P)."""
    G1 = device_g1()
    p = _lanes(pts, 1, lanes)
    q = tuple(c.clone() for c in _lanes(pts, 2, lanes))
    ident = G1.identity("cpu")
    for c, i in zip(q, ident):
        c[:, 0:1] = i                                   # P + O
    pz = tuple(c.clone() for c in p)
    for c, i in zip(pz, ident):
        c[:, 1:3] = i                                   # O + Q, O + O
    for c, i in zip(q, ident):
        c[:, 2:3] = i
    for cp, cq in zip(pz, q):
        cq[:, 3:9] = cp[:, 3:9]                         # P + P
    for cq, cn in zip(q, G1.neg(pz)):
        cq[:, 9:15] = cn[:, 9:15]                       # P + (-P)
    return pz, q


def test_ec_add_plain_matches_jax(pts):
    pz, q = _special_lanes(pts, 128)
    got = kernels.ec_add(device_g1(), pz, q)
    want = jax.jit(jax_g1()._add_xla)(_jax(pz), _jax(q))
    _eq(got, want)


def test_add_mixed_matches_jax(pts):
    """DeviceG1.add_mixed (plain torch over the K1 mul) against
    _add_mixed_xla, with identity lanes on the projective side."""
    G1 = device_g1()
    p = tuple(c.clone() for c in _lanes(pts, 4, 128))
    for c, i in zip(p, G1.identity("cpu")):
        c[:, 0:2] = i
    idx = torch.from_numpy(np.random.default_rng(5).integers(
        0, N_POINTS, size=128))
    q2 = (pts[1][0][:, idx], pts[1][1][:, idx])        # affine table rows
    got = G1.add_mixed(p, q2)
    want = jax.jit(jax_g1()._add_mixed_xla)(_jax(p), _jax(q2))
    _eq(got, want)


@pytest.mark.parametrize("lanes", [128, 512])
def test_ec_add_plain_group_law(pts, lanes):
    G1 = device_g1()
    pz, q = _special_lanes(pts, lanes)
    got = kernels.ec_add(G1, pz, q)
    aff = G1.to_affine(tuple(c[:, :16] for c in got))
    hp = G1.to_affine(tuple(c[:, :16] for c in pz))
    hq = G1.to_affine(tuple(c[:, :16] for c in q))
    for i in range(16):
        exp = bls.g1_add(hp[i], hq[i]) if hp[i] and hq[i] else \
            (hp[i] or hq[i])
        assert aff[i] == exp, i
    assert all(aff[i] is None for i in range(9, 15))


def _scan_input(pts, cl, lanes, seed):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, N_POINTS, size=cl * lanes))
    xy = torch.cat([pts[1][0][:, idx], pts[1][1][:, idx]])   # (48, cl*lanes)
    return idx, xy.reshape(48, cl, lanes).permute(1, 0, 2).contiguous()


def test_ec_scan_mixed_plain_matches_jax_loop(pts):
    cl, lanes = 4, 128
    G1 = device_g1()
    _, g = _scan_input(pts, cl, lanes, cl)
    ps = kernels.ec_scan_mixed(G1, g)
    J = jax_g1()
    add_mixed = jax.jit(J._add_mixed_xla)
    acc = tuple(jnp.broadcast_to(c, (24, lanes)) for c in J.identity)
    gj = jnp.asarray(g.numpy().astype(np.uint32))
    for s in range(cl):
        acc = add_mixed(acc, (gj[s, :24], gj[s, 24:]))
        _eq(tuple(c[s] for c in ps), acc)


@pytest.mark.parametrize("cl,lanes", [(16, 128), (16, 512)])
def test_ec_scan_mixed_plain_lane_sums(pts, cl, lanes):
    """Every step of the scan is the running sum of its lane, in the
    group (host Jacobian arithmetic as the oracle)."""
    G1 = device_g1()
    idx, g = _scan_input(pts, cl, lanes, cl + lanes)
    ps = kernels.ec_scan_mixed(G1, g)
    for s in (0, cl // 2, cl - 1):
        got = G1.to_affine(tuple(c[s, :, :6] for c in ps))
        for lane in range(6):
            want = None
            for t in range(s + 1):
                p = pts[0][int(idx[t * lanes + lane])]
                want = p if want is None else bls.g1_add(want, p)
            assert got[lane] == want, (s, lane)


def test_ec_add_broadcasts_identity(pts):
    G1 = device_g1()
    p = _lanes(pts, 3, 8)
    got = G1.add(p, G1.identity("cpu"))
    assert G1.to_affine(got) == G1.to_affine(p)


def test_non_cpu_tensor_never_takes_the_plain_route():
    G1 = device_g1()
    meta = tuple(torch.empty((24, 4), dtype=torch.int32, device="meta")
                 for _ in range(3))
    with pytest.raises(ValueError):
        kernels.ec_add(G1, meta, meta)
    with pytest.raises(ValueError):
        kernels.ec_scan_mixed(G1, torch.empty((2, 48, 4), dtype=torch.int32,
                                              device="meta"))
