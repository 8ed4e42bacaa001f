"""The port's mesh-sharded prover at D = 8 under the bit-serial MSM tier
(see test_torch_sharded_engine.py): every commitment by double-and-add on
each shard, the proof equal to the JAX package's host-oracle proof byte
for byte, and verified."""

import torch

from test_torch_sharded_engine import check_against_host, sharded_proof

torch.set_num_threads(1)


def test_sharded_proof_bit_serial_equals_host():
    proof, pis, engine = sharded_proof(8, msm_tier="bit_serial")
    assert engine.smsm.tier == "bit_serial"
    check_against_host(proof, pis)
