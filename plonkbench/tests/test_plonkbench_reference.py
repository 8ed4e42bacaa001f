"""The reference against a proof that the port's CPU path makes: the proof
is accepted, and any byte or evaluation changed in it is refused.  Also
the reference's limb arithmetic against Python integers."""

import random

import pytest
import torch

from plonkbench import traffic
from plonkbench.circuits import bench_chain
from plonkbench.reference import check
from plonkbench.reference.constants import R_MOD
from plonkbench.reference.fr_limbs import FrVec

K = 6
PARAMS = {"k": K, "mul_gates_below_n": 40, "range_bits": 8, "logic_bits": 8}
SRS_SEED, BLINDER_SEED, X = 2 ** 33 + 5, 2 ** 40 + 9, 201


@pytest.fixture(scope="module")
def made():
    """(circuit class, pp, verifier, proof, public inputs) from the port."""
    from dusk_plonk_torch.prelude import ChaCha12Rng, PlonkKey, PlonkParams
    torch.set_num_threads(4)
    circuit = bench_chain.build(PARAMS)
    pp = PlonkParams.setup_device(K, ChaCha12Rng.seed_from_u64(SRS_SEED),
                                  "cpu")
    prover, verifier = PlonkKey.compile_device(pp, circuit, device="cpu")
    proof, pis = prover.create_proof(ChaCha12Rng.seed_from_u64(
        BLINDER_SEED), circuit(X))
    verifier.verify(proof, pis)
    return circuit, pp, verifier, proof, pis


@pytest.fixture(scope="module")
def key(made):
    return check.CircuitKey(made[0](), check.derive_tau(SRS_SEED), "cpu")


def _check(key, made, proof):
    circuit, *_, pis = made
    comms = {f: getattr(proof, f) for f in check.COMMITMENTS}
    return key.check_proof(circuit(X), BLINDER_SEED, comms,
                           dict(proof.evaluations), pis)


def test_the_ports_proof_is_accepted(made, key):
    circuit, pp, verifier, proof, _ = made
    assert key.n == 1 << K
    assert sum(_check(key, made, proof).values()) == 0
    powers = {i: pp.powers[i] for i in (0, 1, 17, len(pp.powers) - 1)}
    assert key.check_srs(powers, pp.h, pp.beta_h) == 0
    vk, ok = verifier.verifier_key, verifier.opening_key
    assert key.check_vk(vk.commitments, vk.n, vk.n_inv, vk.generator,
                        vk.generator_inv, (ok.g, ok.h, ok.beta_h)) == 0


def test_every_byte_of_the_proof_counts(made, key):
    """A changed byte in each commitment and in each evaluation."""
    from dusk_plonk_torch.proving.proof import Proof
    proof = made[3]
    data = proof.to_bytes()
    rnd = random.Random(1)
    offsets = [97 * i + rnd.randrange(1, 48) for i in range(11)] + \
        [11 * 97 + 32 * i + rnd.randrange(0, 31) for i in range(16)]
    refused = 0
    for off in offsets:
        bad = bytearray(data)
        bad[off] ^= 0x01
        try:
            other = Proof.from_bytes(bytes(bad))
        except (ValueError, ArithmeticError):
            refused += 1            # no longer a proof at all
            continue
        refused += sum(_check(key, made, other).values()) > 0
    assert refused == len(offsets)


@pytest.mark.parametrize("name", check.EVALUATIONS)
def test_one_evaluation_changed_is_refused(made, key, name):
    proof = made[3]
    evals = dict(proof.evaluations)
    evals[name] = (evals[name] + 1) % R_MOD
    circuit, *_, pis = made
    comms = {f: getattr(proof, f) for f in check.COMMITMENTS}
    bad = key.check_proof(circuit(X), BLINDER_SEED, comms, evals, pis)
    assert bad["eval_mismatch"] >= 1


@pytest.mark.parametrize("field", check.COMMITMENTS)
def test_one_commitment_changed_is_refused(made, key, field):
    from plonkbench.reference import bls
    proof = made[3]
    comms = {f: getattr(proof, f) for f in check.COMMITMENTS}
    comms[field] = bls.g1_add(comms[field], bls.G1_GENERATOR)
    circuit, *_, pis = made
    bad = key.check_proof(circuit(X), BLINDER_SEED, comms,
                          dict(proof.evaluations), pis)
    assert sum(bad.values()) >= 1


def test_another_witness_or_blinder_is_refused(made, key):
    circuit, *_, proof, pis = made
    comms = {f: getattr(proof, f) for f in check.COMMITMENTS}
    evals = dict(proof.evaluations)
    assert key.check_proof(circuit(X + 1), BLINDER_SEED, comms, evals,
                           pis)["commit_mismatch"] > 0
    assert key.check_proof(circuit(X), BLINDER_SEED + 1, comms, evals,
                           pis)["commit_mismatch"] > 0


def test_a_wrong_srs_or_key_is_refused(made, key):
    _, pp, verifier, *_ = made
    powers = {1: pp.powers[2], 2: pp.powers[2]}
    assert key.check_srs(powers, pp.h, pp.beta_h) == 1
    vk, ok = verifier.verifier_key, verifier.opening_key
    comms = dict(vk.commitments)
    comms["q_m"], comms["q_l"] = comms["q_l"], comms["q_m"]
    assert key.check_vk(comms, vk.n, vk.n_inv, vk.generator,
                        vk.generator_inv, (ok.g, ok.h, ok.beta_h)) == 2


def test_tau_is_the_first_draw_of_the_srs_stream(made):
    from dusk_plonk_torch.prelude import ChaCha12Rng, fr_random
    assert check.derive_tau(SRS_SEED) == fr_random(
        ChaCha12Rng.seed_from_u64(SRS_SEED))
    pp = made[1]
    from plonkbench.reference import bls
    assert pp.powers[1] == bls.g1_mul(bls.G1_GENERATOR,
                                      check.derive_tau(SRS_SEED))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 255])
def test_limb_arithmetic_equals_python_integers(n):
    F = FrVec("cpu")
    rnd = random.Random(n)
    a = [rnd.randrange(R_MOD) for _ in range(n)]
    b = [rnd.randrange(1, R_MOD) for _ in range(n)]
    a[0], b[0] = R_MOD - 1, R_MOD - 1
    A, B = F.upload(a), F.upload(b)

    def back(t):
        return [F.to_int(t[:, i:i + 1]) for i in range(t.shape[1])]

    assert back(A) == a
    assert back(F.mul(A, B)) == [x * y % R_MOD for x, y in zip(a, b)]
    assert back(F.add(A, B)) == [(x + y) % R_MOD for x, y in zip(a, b)]
    assert back(F.sub(A, B)) == [(x - y) % R_MOD for x, y in zip(a, b)]
    assert F.dot(A, B) == sum(x * y for x, y in zip(a, b)) % R_MOD
    assert back(F.inv(B)) == [pow(y, -1, R_MOD) for y in b]
    acc, pre = 1, []
    for y in b:
        acc = acc * y % R_MOD
        pre.append(acc)
    assert back(F.prefix(B)) == pre
    assert back(F.powers(a[-1], n)) == [pow(a[-1], j, R_MOD)
                                        for j in range(n)]


def test_seed_derivation_is_fixed():
    # the same seed gives the same SRS secret on any machine
    assert traffic.derive(0, "srs") == traffic.derive(0, "srs")
    assert traffic.derive(2 ** 31 + 1, "srs") != traffic.derive(
        2 ** 31 + 2, "srs")
    assert 0 <= traffic.derive(-5, "srs") < 2 ** 64
