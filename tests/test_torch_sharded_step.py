"""`sharded_prover_step` (dusk_plonk_torch/parallel/prover_step.py)
against host computations of the same steps, on an 8-shard CPU mesh; and
the single-device TorchEngine's proof of the sharded tests' circuit,
equal to the same JAX host-oracle bytes that the sharded proofs of
test_torch_sharded_engine*.py are held to."""

import numpy as np
import pytest
import torch

import dusk_plonk_torch.prelude as pt
from dusk_plonk_torch import native
from dusk_plonk_torch.fields.constants import R_MOD
from dusk_plonk_torch.ops.ec import device_g1
from dusk_plonk_torch.ops.limb import fr_field
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.parallel import sharded_prover_step
from dusk_plonk_torch.poly.domain import Domain
from dusk_plonk_torch.proving.keys import compile_circuit_torch

from test_torch_sharded_engine import SEED, check_against_host, wide_circuit
from test_torch_sharded_msm import host_points

torch.set_num_threads(1)


def test_sharded_prover_step_equals_host():
    k, d, B, npts = 6, 8, 2, 16
    n = 1 << k
    F = fr_field()
    rng = np.random.default_rng(31)
    vals = [[int.from_bytes(rng.bytes(32), "little") % R_MOD
             for _ in range(n)] for _ in range(B)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD
               for _ in range(npts)]
    pts = host_points(npts)
    wires = F.pack([v for row in vals for v in row], "cpu", shape=(B, n))
    points = device_g1().pack_points(pts, "cpu")
    limbs = F.pack(scalars, "cpu", to_mont=False)
    z, commit = sharded_prover_step(M.Mesh(["cpu"] * d), k,
                                    (wires, points, limbs))

    dom = Domain(k)
    e = dom.coset_dft(dom.idft(vals[0]))
    want, acc = [], 1
    for i in range(n):
        acc = acc * ((e[i] + e[(i + 1) % n]) * e[i] + 1) % R_MOD
        want.append(acc)
    assert F.unpack(z) == want
    assert device_g1().to_affine(commit)[0] == native.g1_msm(
        pts, [s % (1 << 32) for s in scalars])


def test_torch_engine_proof_equals_host():
    Wide = wide_circuit(pt)
    rng = pt.ChaCha12Rng.seed_from_u64(SEED)
    prover, _ = compile_circuit_torch(pt.PlonkParams.setup(7, rng), Wide(),
                                      "cpu")
    proof, pis = prover.create_proof(rng, Wide(3))
    check_against_host(proof, pis)


def test_default_mesh_takes_the_cuda_devices_or_raises():
    """No mesh given: every visible CUDA device, and without one an error
    (a CPU mesh is made only from CPU devices passed in)."""
    from dusk_plonk_torch.proving.sharded_engine import ShardedEngine
    if torch.cuda.is_available():
        mesh = M.default_mesh()
        assert mesh.devices == tuple(torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count()))
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEngine(prover=None)
