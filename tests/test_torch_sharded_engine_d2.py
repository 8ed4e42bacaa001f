"""The port's mesh-sharded prover at D = 2 on the CPU (see
test_torch_sharded_engine.py): both domains take the four-step route
over two shards of 32 and 256 points; the proof equals the JAX package's
host-oracle proof byte for byte and verifies."""

import torch

from test_torch_sharded_engine import check_against_host, sharded_proof

torch.set_num_threads(1)


def test_sharded_proof_d2_equals_host():
    proof, pis, engine = sharded_proof(2)
    assert (engine.D, engine.nsd) == (2, 72)
    check_against_host(proof, pis)
