"""The 5-round PLONK prover.

Behavioral port of reference src/prover.rs (create_proof trace in SURVEY.md
§3.2) with the reference's exact transcript label schedule.  Heavy math
(NTT, 8n quotient grid, MSM commits) is routed through an engine object so
the host oracle and the TPU device engine share this orchestration; the
engine is selected at Prover construction (host by default, device via
`use_device_engine()`).
"""

from __future__ import annotations

from ..fields.constants import R_MOD
from ..poly.domain import Domain
from ..poly.coefficients import poly_evaluate, poly_add, poly_scale, poly_blind
from ..composer.composer import Plonk, Error
from ..transcript.plonk_transcript import PlonkTranscript
from . import widgets
from .widgets import HostOps
from .proof import Proof


def _trim_zeros(coeffs: list[int]) -> list[int]:
    """Coefficients::new-style trailing-zero trim (degree formatting): an
    unsatisfied circuit leaves a ~5n-degree garbage t_4 chunk whose commit
    then exceeds the SRS — that's the reference's negative-test error path."""
    i = len(coeffs)
    while i > 1 and coeffs[i - 1] == 0:
        i -= 1
    return coeffs[:i]


class Prover:
    def __init__(self, label, keypair, prover_key, verifier_key, size,
                 constraints):
        self.prover_key = prover_key
        self.keypair = keypair
        self.verifier_key = verifier_key
        self.size = size
        self.constraints = constraints
        self.transcript = PlonkTranscript.base(
            label, verifier_key.commitments, constraints)
        self.engine = None  # device engine injected by use_device_engine()

    def use_device_engine(self, engine) -> "Prover":
        self.engine = engine
        return self

    # -- helpers -------------------------------------------------------------

    def _commit(self, coeffs):
        try:
            return self.keypair.commit(_trim_zeros(coeffs))
        except ValueError as exc:
            raise Error(str(exc)) from exc

    def create_proof(self, rng, circuit):
        if self.engine is not None:
            return self.engine.create_proof(self, rng, circuit)
        return self._create_proof_host(rng, circuit)

    # -- host oracle path ------------------------------------------------------

    def _create_proof_host(self, rng, circuit):
        pk = self.prover_key
        domain: Domain = pk.domain
        n = self.size

        cs = Plonk.initialize()
        circuit.synthesize(cs)

        transcript = self.transcript.clone()

        public_inputs = cs.instance_values()
        public_input_indexes = cs.public_input_indexes()
        dense_pi = Plonk.dense_public_inputs(
            public_input_indexes, public_inputs, n)
        for pi in public_inputs:
            transcript.append_scalar(b"pi", pi)

        # ---- round 1: wire polynomials -----------------------------------
        wires_eval = [[0] * n for _ in range(4)]
        for i, c in enumerate(cs.constraints):
            wires_eval[0][i] = cs.witness[c.w_a]
            wires_eval[1][i] = cs.witness[c.w_b]
            wires_eval[2][i] = cs.witness[c.w_o]
            wires_eval[3][i] = cs.witness[c.w_d]

        wire_polys = [domain.idft(w) for w in wires_eval]
        wire_polys = [poly_blind(p, 1, rng) for p in wire_polys]
        a_w_poly, b_w_poly, o_w_poly, d_w_poly = wire_polys

        commits = [self._commit(p) for p in wire_polys]
        for label, comm in zip((b"a_w", b"b_w", b"c_w", b"d_w"), commits):
            transcript.append_commitment(label, comm)
        a_comm, b_comm, c_comm, d_comm = commits

        # ---- round 2: permutation polynomial ------------------------------
        beta = transcript.challenge_scalar(b"beta")
        transcript.append_scalar(b"beta", beta)
        gamma = transcript.challenge_scalar(b"gamma")

        z_vec = cs.perm.compute_permutation_vec(
            domain, wires_eval, beta, gamma, pk.sigma_polys)
        z_poly = poly_blind(domain.idft(z_vec), 2, rng)
        z_comm = self._commit(z_poly)
        transcript.append_commitment(b"z", z_comm)

        # ---- round 3: quotient polynomial ----------------------------------
        alpha = transcript.challenge_scalar(b"alpha")
        range_sep = transcript.challenge_scalar(
            b"range separation challenge")
        logic_sep = transcript.challenge_scalar(
            b"logic separation challenge")
        fixed_base_sep = transcript.challenge_scalar(
            b"fixed base separation challenge")
        var_base_sep = transcript.challenge_scalar(
            b"variable base separation challenge")
        challenges = dict(alpha=alpha, beta=beta, gamma=gamma,
                          range_sep=range_sep, logic_sep=logic_sep,
                          fixed_base_sep=fixed_base_sep,
                          var_base_sep=var_base_sep)

        pi_poly = domain.idft(dense_pi)
        t_poly = compute_quotient_host(
            pk, z_poly, (a_w_poly, b_w_poly, o_w_poly, d_w_poly),
            pi_poly, challenges)

        t_chunks = [t_poly[0:n], t_poly[n:2 * n], t_poly[2 * n:3 * n],
                    t_poly[3 * n:]]
        t_commits = [self._commit(c) for c in t_chunks]
        for label, comm in zip((b"t_low", b"t_mid", b"t_high", b"t_4"),
                               t_commits):
            transcript.append_commitment(label, comm)

        # ---- round 4: evaluation challenge ---------------------------------
        z_challenge = transcript.challenge_scalar(b"z_challenge")

        # ---- round 5: linearization + evaluations ---------------------------
        r_poly, evals, t_eval = compute_linearization(
            pk, challenges, z_challenge,
            (a_w_poly, b_w_poly, o_w_poly, d_w_poly), t_poly, z_poly)

        for label, key in EVAL_TRANSCRIPT_ORDER:
            transcript.append_scalar(label, evals[key])
        transcript.append_scalar(b"t_eval", t_eval)
        transcript.append_scalar(b"r_eval", evals["r_poly_eval"])

        # ---- openings --------------------------------------------------------
        z_n = pow(z_challenge, n, R_MOD)
        z_two_n = pow(z_challenge, 2 * n, R_MOD)
        z_three_n = pow(z_challenge, 3 * n, R_MOD)
        quot = poly_add(
            poly_add(t_chunks[0], poly_scale(t_chunks[1], z_n)),
            poly_add(poly_scale(t_chunks[2], z_two_n),
                     poly_scale(t_chunks[3], z_three_n)))

        v_challenge = transcript.challenge_scalar(b"v_challenge")
        aggregate_witness = self.keypair.compute_aggregate_witness(
            [quot, r_poly, a_w_poly, b_w_poly, o_w_poly, d_w_poly,
             pk.sigma_polys[0], pk.sigma_polys[1], pk.sigma_polys[2]],
            z_challenge, v_challenge)
        w_z_chall_comm = self._commit(aggregate_witness)

        v_challenge_shifted = transcript.challenge_scalar(b"v_challenge")
        shifted_witness = self.keypair.compute_aggregate_witness(
            [z_poly, a_w_poly, b_w_poly, d_w_poly],
            z_challenge * domain.generator % R_MOD, v_challenge_shifted)
        w_z_chall_w_comm = self._commit(shifted_witness)

        proof = Proof(
            a_comm=a_comm, b_comm=b_comm, c_comm=c_comm, d_comm=d_comm,
            z_comm=z_comm,
            t_low_comm=t_commits[0], t_mid_comm=t_commits[1],
            t_high_comm=t_commits[2], t_4_comm=t_commits[3],
            w_z_chall_comm=w_z_chall_comm,
            w_z_chall_w_comm=w_z_chall_w_comm,
            evaluations=evals)
        return proof, public_inputs


EVAL_TRANSCRIPT_ORDER = [
    (b"a_eval", "a_eval"), (b"b_eval", "b_eval"), (b"c_eval", "c_eval"),
    (b"d_eval", "d_eval"), (b"a_next_eval", "a_next_eval"),
    (b"b_next_eval", "b_next_eval"), (b"d_next_eval", "d_next_eval"),
    (b"s_sigma_1_eval", "s_sigma_1_eval"),
    (b"s_sigma_2_eval", "s_sigma_2_eval"),
    (b"s_sigma_3_eval", "s_sigma_3_eval"),
    (b"q_arith_eval", "q_arith_eval"), (b"q_c_eval", "q_c_eval"),
    (b"q_l_eval", "q_l_eval"), (b"q_r_eval", "q_r_eval"),
    (b"perm_eval", "perm_eval"),
]


def compute_quotient_host(pk, z_poly, wire_polys, pi_poly, ch):
    """Host oracle for the quotient pipeline
    (reference src/prover/quotient_poly.rs:20-118)."""
    d8: Domain = pk.domain_8n
    n8 = d8.size

    z8 = d8.coset_dft(z_poly)
    a8 = d8.coset_dft(wire_polys[0])
    b8 = d8.coset_dft(wire_polys[1])
    c8 = d8.coset_dft(wire_polys[2])
    d8w = d8.coset_dft(wire_polys[3])
    pi8 = d8.coset_dft(pi_poly)

    sel = pk.selector_evals_8n
    sig = pk.sigma_evals_8n
    lin = pk.linear_evals_8n

    # L1 * alpha^2 over the coset
    l1_scaled = [0] * pk.domain.size
    l1_scaled[0] = ch["alpha"] * ch["alpha"] % R_MOD
    l1_alpha_sq = d8.coset_dft(pk.domain.idft(l1_scaled))

    ops = HostOps
    out = [0] * n8
    for i in range(n8):
        j = (i + 8) % n8  # next-gate wraparound (quotient_poly.rs:60-66)
        a, b, c, d = a8[i], b8[i], c8[i], d8w[i]
        a_n, b_n, d_n = a8[j], b8[j], d8w[j]
        t = widgets.arithmetic_quotient(
            ops, sel["q_m"][i], sel["q_l"][i], sel["q_r"][i], sel["q_o"][i],
            sel["q_c"][i], sel["q_4"][i], sel["q_arith"][i], a, b, c, d)
        t = (t + pi8[i]) % R_MOD
        t = (t + widgets.range_quotient(
            ops, sel["q_range"][i], ch["range_sep"], a, b, c, d, d_n)) % R_MOD
        t = (t + widgets.logic_quotient(
            ops, sel["q_logic"][i], sel["q_c"][i], ch["logic_sep"],
            a, a_n, b, b_n, c, d, d_n)) % R_MOD
        t = (t + widgets.fixed_base_quotient(
            ops, sel["q_fixed_group_add"][i], sel["q_l"][i], sel["q_r"][i],
            sel["q_c"][i], ch["fixed_base_sep"],
            a, a_n, b, b_n, c, d, d_n)) % R_MOD
        t = (t + widgets.variable_base_quotient(
            ops, sel["q_variable_group_add"][i], ch["var_base_sep"],
            a, a_n, b, b_n, c, d, d_n)) % R_MOD
        t = (t + widgets.permutation_quotient(
            ops, lin[i], sig[0][i], sig[1][i], sig[2][i], sig[3][i],
            a, b, c, d, z8[i], z8[j],
            ch["alpha"], l1_alpha_sq[i], ch["beta"], ch["gamma"])) % R_MOD
        out[i] = t * pk.v_h_coset_8n_inv[i] % R_MOD

    return d8.coset_idft(out)


def compute_first_lagrange_eval(n: int, z_h_eval: int, z_challenge: int) -> int:
    """L1(z) = Z_H(z) / (n (z - 1)) (reference src/prover/proof.rs:530-538)."""
    denom = n * (z_challenge - 1) % R_MOD
    return z_h_eval * pow(denom, -1, R_MOD) % R_MOD


def compute_linearization(pk, challenges, z_challenge, wire_polys, t_poly,
                          z_poly):
    """r(X) and the 16 proof evaluations
    (reference src/prover/linearization_poly.rs:22-134)."""
    domain: Domain = pk.domain
    zw = z_challenge * domain.generator % R_MOD

    evals = {
        "a_eval": poly_evaluate(wire_polys[0], z_challenge),
        "b_eval": poly_evaluate(wire_polys[1], z_challenge),
        "c_eval": poly_evaluate(wire_polys[2], z_challenge),
        "d_eval": poly_evaluate(wire_polys[3], z_challenge),
        "a_next_eval": poly_evaluate(wire_polys[0], zw),
        "b_next_eval": poly_evaluate(wire_polys[1], zw),
        "d_next_eval": poly_evaluate(wire_polys[3], zw),
        "s_sigma_1_eval": poly_evaluate(pk.sigma_polys[0], z_challenge),
        "s_sigma_2_eval": poly_evaluate(pk.sigma_polys[1], z_challenge),
        "s_sigma_3_eval": poly_evaluate(pk.sigma_polys[2], z_challenge),
        "q_arith_eval": poly_evaluate(pk.selector_polys["q_arith"], z_challenge),
        "q_c_eval": poly_evaluate(pk.selector_polys["q_c"], z_challenge),
        "q_l_eval": poly_evaluate(pk.selector_polys["q_l"], z_challenge),
        "q_r_eval": poly_evaluate(pk.selector_polys["q_r"], z_challenge),
        "perm_eval": poly_evaluate(z_poly, zw),
    }
    t_eval = poly_evaluate(t_poly, z_challenge)

    n = domain.size
    z_h_eval = (pow(z_challenge, n, R_MOD) - 1) % R_MOD
    l1_eval = compute_first_lagrange_eval(n, z_h_eval, z_challenge)

    scalars = widgets.linearization_scalars(
        evals, challenges, l1_eval, z_challenge)
    r_poly: list[int] = []
    for key, s in scalars:
        if key == "z_poly":
            src = z_poly
        elif key == "s_sigma_4":
            src = pk.sigma_polys[3]
        else:
            src = pk.selector_polys[key]
        r_poly = poly_add(r_poly, poly_scale(src, s))
    evals["r_poly_eval"] = poly_evaluate(r_poly, z_challenge)
    return r_poly, evals, t_eval
