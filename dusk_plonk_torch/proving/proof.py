"""Proof container and verification math.

Behavioral port of reference src/prover/proof.rs: 11 G1 commitments +
16 scalar evaluations, transcript replay, barycentric PI evaluation,
t_eval reconstruction, folded quotient commitment, linearization
commitment, and the 2-proof batched KZG pairing check."""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import R_MOD
from ..fields.host import fr_batch_inv
from ..curves import bls
from ..composer.composer import ProofVerificationError
from . import widgets

COMMITMENT_FIELDS = (
    "a_comm", "b_comm", "c_comm", "d_comm", "z_comm",
    "t_low_comm", "t_mid_comm", "t_high_comm", "t_4_comm",
    "w_z_chall_comm", "w_z_chall_w_comm",
)

EVAL_FIELDS = (
    "a_eval", "b_eval", "c_eval", "d_eval",
    "a_next_eval", "b_next_eval", "d_next_eval",
    "s_sigma_1_eval", "s_sigma_2_eval", "s_sigma_3_eval",
    "q_arith_eval", "q_c_eval", "q_l_eval", "q_r_eval",
    "r_poly_eval", "perm_eval",
)


# SCALE field order of ProofEvaluations as constructed at reference
# src/prover/linearization_poly.rs:113-130 (field-init shorthand tracks the
# zksnarks declaration order)
SCALE_EVAL_ORDER = (
    "a_eval", "b_eval", "c_eval", "d_eval",
    "a_next_eval", "b_next_eval", "d_next_eval",
    "q_arith_eval", "q_c_eval", "q_l_eval", "q_r_eval",
    "s_sigma_1_eval", "s_sigma_2_eval", "s_sigma_3_eval",
    "r_poly_eval", "perm_eval",
)

# Montgomery constants for the SCALE raw-limb layout (the Kogarashi field
# structs store Montgomery limbs; derived parity-scale-codec Encode emits
# them verbatim as little-endian u64 words)
_Q_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
_R_FQ = (1 << 384) % _Q_MOD
_R_FR = (1 << 256) % R_MOD


def _fq_scale(x: int) -> bytes:
    return (x * _R_FQ % _Q_MOD).to_bytes(48, "little")


def _fq_unscale(b: bytes) -> int:
    return int.from_bytes(b, "little") * pow(_R_FQ, -1, _Q_MOD) % _Q_MOD


def _fr_scale(x: int) -> bytes:
    return (x * _R_FR % R_MOD).to_bytes(32, "little")


def _fr_unscale(b: bytes) -> int:
    return int.from_bytes(b, "little") * pow(_R_FR, -1, R_MOD) % R_MOD


def _g1_scale(p) -> bytes:
    """G1Affine SCALE: x (48B Montgomery LE), y (48B), is_infinity (1B)."""
    if p is None:
        return b"\x00" * 96 + b"\x01"
    return _fq_scale(p[0]) + _fq_scale(p[1]) + b"\x00"


def _g1_unscale(b: bytes):
    if b[96] == 1:
        return None
    return (_fq_unscale(b[0:48]), _fq_unscale(b[48:96]))


def _g2_scale(p) -> bytes:
    """G2Affine SCALE: x.c0, x.c1, y.c0, y.c1 (48B Montgomery LE each) +
    is_infinity (1B)."""
    if p is None:
        return b"\x00" * 192 + b"\x01"
    (x0, x1), (y0, y1) = p
    return (_fq_scale(x0) + _fq_scale(x1)
            + _fq_scale(y0) + _fq_scale(y1) + b"\x00")


def _g2_unscale(b: bytes):
    if b[192] == 1:
        return None
    return ((_fq_unscale(b[0:48]), _fq_unscale(b[48:96])),
            (_fq_unscale(b[96:144]), _fq_unscale(b[144:192])))


def scale_compact_encode(n: int) -> bytes:
    """parity-scale-codec compact<u32> encoding."""
    if n < 1 << 6:
        return bytes([n << 2])
    if n < 1 << 14:
        return ((n << 2) | 0b01).to_bytes(2, "little")
    if n < 1 << 30:
        return ((n << 2) | 0b10).to_bytes(4, "little")
    raise ValueError("compact length out of range")


def scale_compact_decode(data: bytes, off: int):
    mode = data[off] & 0b11
    if mode == 0b00:
        return data[off] >> 2, off + 1
    if mode == 0b01:
        return int.from_bytes(data[off:off + 2], "little") >> 2, off + 2
    if mode == 0b10:
        return int.from_bytes(data[off:off + 4], "little") >> 2, off + 4
    raise ValueError("unsupported compact mode")


@dataclass
class Proof:
    a_comm: tuple
    b_comm: tuple
    c_comm: tuple
    d_comm: tuple
    z_comm: tuple
    t_low_comm: tuple
    t_mid_comm: tuple
    t_high_comm: tuple
    t_4_comm: tuple
    w_z_chall_comm: tuple
    w_z_chall_w_comm: tuple
    evaluations: dict

    def to_bytes(self) -> bytes:
        """parity-scale-codec Encode layout (reference derives Encode at
        src/prover/proof.rs:36): 11 x 97-byte G1Affine (Montgomery-limb
        x, y, infinity flag) + 16 x 32-byte Fr = 1579 bytes."""
        out = b"".join(_g1_scale(getattr(self, f))
                       for f in COMMITMENT_FIELDS)
        out += b"".join(_fr_scale(self.evaluations[k])
                        for k in SCALE_EVAL_ORDER)
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> "Proof":
        if len(data) != 11 * 97 + 16 * 32:
            raise ValueError(f"bad proof length {len(data)}")
        fields = {}
        off = 0
        for f in COMMITMENT_FIELDS:
            fields[f] = _g1_unscale(data[off:off + 97])
            off += 97
        evals = {}
        for k in SCALE_EVAL_ORDER:
            evals[k] = _fr_unscale(data[off:off + 32])
            off += 32
        return cls(evaluations=evals, **fields)

    def verify(self, verifier_key, transcript, opening_key, pub_inputs):
        """pub_inputs: sparse [(gate_index, value)] pairs (the dense
        reference form carries the same information; only nonzero
        entries enter the barycentric sum, proof.rs:550-560)."""
        e = self.evaluations

        for label, comm in ((b"a_w", self.a_comm), (b"b_w", self.b_comm),
                            (b"c_w", self.c_comm), (b"d_w", self.d_comm)):
            transcript.append_commitment(label, comm)

        beta = transcript.challenge_scalar(b"beta")
        transcript.append_scalar(b"beta", beta)
        gamma = transcript.challenge_scalar(b"gamma")

        transcript.append_commitment(b"z", self.z_comm)

        alpha = transcript.challenge_scalar(b"alpha")
        range_sep = transcript.challenge_scalar(b"range separation challenge")
        logic_sep = transcript.challenge_scalar(b"logic separation challenge")
        fixed_base_sep = transcript.challenge_scalar(
            b"fixed base separation challenge")
        var_base_sep = transcript.challenge_scalar(
            b"variable base separation challenge")

        for label, comm in ((b"t_low", self.t_low_comm),
                            (b"t_mid", self.t_mid_comm),
                            (b"t_high", self.t_high_comm),
                            (b"t_4", self.t_4_comm)):
            transcript.append_commitment(label, comm)

        z_challenge = transcript.challenge_scalar(b"z_challenge")

        # next_power_of_two of the raw constraint count (proof.rs:180)
        m = verifier_key.n
        n = 1 << max(m - 1, 0).bit_length() if m > 1 else 1

        z_h_eval = (pow(z_challenge, n, R_MOD) - 1) % R_MOD
        l1_eval = z_h_eval * pow(n * (z_challenge - 1) % R_MOD, -1,
                                 R_MOD) % R_MOD

        t_eval = self._compute_quotient_evaluation(
            n, verifier_key, pub_inputs, alpha, beta, gamma, z_challenge,
            z_h_eval, l1_eval)

        t_comm = self._compute_quotient_commitment(z_challenge, n)

        for label, key in (
                (b"a_eval", "a_eval"), (b"b_eval", "b_eval"),
                (b"c_eval", "c_eval"), (b"d_eval", "d_eval"),
                (b"a_next_eval", "a_next_eval"),
                (b"b_next_eval", "b_next_eval"),
                (b"d_next_eval", "d_next_eval"),
                (b"s_sigma_1_eval", "s_sigma_1_eval"),
                (b"s_sigma_2_eval", "s_sigma_2_eval"),
                (b"s_sigma_3_eval", "s_sigma_3_eval"),
                (b"q_arith_eval", "q_arith_eval"),
                (b"q_c_eval", "q_c_eval"),
                (b"q_l_eval", "q_l_eval"), (b"q_r_eval", "q_r_eval"),
                (b"perm_eval", "perm_eval")):
            transcript.append_scalar(label, e[key])
        transcript.append_scalar(b"t_eval", t_eval)
        transcript.append_scalar(b"r_eval", e["r_poly_eval"])

        challenges = dict(alpha=alpha, beta=beta, gamma=gamma,
                          range_sep=range_sep, logic_sep=logic_sep,
                          fixed_base_sep=fixed_base_sep,
                          var_base_sep=var_base_sep)
        r_comm = self._compute_linearization_commitment(
            challenges, z_challenge, l1_eval, verifier_key)

        # aggregate proof at z (9 parts, order proof.rs:320-342)
        agg_evals = [t_eval, e["r_poly_eval"], e["a_eval"], e["b_eval"],
                     e["c_eval"], e["d_eval"], e["s_sigma_1_eval"],
                     e["s_sigma_2_eval"], e["s_sigma_3_eval"]]
        agg_comms = [t_comm, r_comm, self.a_comm, self.b_comm, self.c_comm,
                     self.d_comm,
                     verifier_key.commitments["s_sigma_1"],
                     verifier_key.commitments["s_sigma_2"],
                     verifier_key.commitments["s_sigma_3"]]
        flat_a = _flatten_aggregate(transcript, agg_evals, agg_comms,
                                    self.w_z_chall_comm)

        # shifted aggregate proof at z*omega (4 parts)
        sh_evals = [e["perm_eval"], e["a_next_eval"], e["b_next_eval"],
                    e["d_next_eval"]]
        sh_comms = [self.z_comm, self.a_comm, self.b_comm, self.d_comm]
        flat_b = _flatten_aggregate(transcript, sh_evals, sh_comms,
                                    self.w_z_chall_w_comm)

        transcript.append_commitment(b"w_z", self.w_z_chall_comm)
        transcript.append_commitment(b"w_z_w", self.w_z_chall_w_comm)

        ok = _batch_check(
            opening_key,
            [z_challenge, z_challenge * verifier_key.generator % R_MOD],
            [flat_a, flat_b],
            transcript)
        if not ok:
            raise ProofVerificationError("pairing check failed")

    # ------------------------------------------------------------------

    def _compute_quotient_evaluation(self, n, vk, pub_inputs, alpha, beta,
                                     gamma, z_challenge, z_h_eval, l1_eval):
        e = self.evaluations
        pi_eval = _barycentric_eval(pub_inputs, z_challenge, n,
                                    vk.n_inv, vk.generator_inv)
        alpha_sq = alpha * alpha % R_MOD
        a = (e["r_poly_eval"] + pi_eval) % R_MOD
        b_0 = (e["a_eval"] + beta * e["s_sigma_1_eval"] + gamma) % R_MOD
        b_1 = (e["b_eval"] + beta * e["s_sigma_2_eval"] + gamma) % R_MOD
        b_2 = (e["c_eval"] + beta * e["s_sigma_3_eval"] + gamma) % R_MOD
        b_3 = (e["d_eval"] + gamma) % R_MOD * e["perm_eval"] % R_MOD \
            * alpha % R_MOD
        b = b_0 * b_1 % R_MOD * b_2 % R_MOD * b_3 % R_MOD
        c = l1_eval * alpha_sq % R_MOD
        return (a - b - c) % R_MOD * pow(z_h_eval, -1, R_MOD) % R_MOD

    def _compute_quotient_commitment(self, z_challenge, n):
        z_n = pow(z_challenge, n, R_MOD)
        z_two_n = pow(z_challenge, 2 * n, R_MOD)
        z_three_n = pow(z_challenge, 3 * n, R_MOD)
        return bls.g1_msm(
            [self.t_low_comm, self.t_mid_comm, self.t_high_comm,
             self.t_4_comm],
            [1, z_n, z_two_n, z_three_n])

    def _compute_linearization_commitment(self, challenges, z_challenge,
                                          l1_eval, vk):
        scalars = widgets.linearization_scalars(
            self.evaluations, challenges, l1_eval, z_challenge)
        points = []
        weights = []
        for key, s in scalars:
            if key == "z_poly":
                points.append(self.z_comm)
            elif key == "s_sigma_4":
                points.append(vk.commitments["s_sigma_4"])
            else:
                points.append(vk.commitments[key])
            weights.append(s)
        return bls.g1_msm(points, weights)


def _barycentric_eval(sparse_evals, point, n, n_inv, generator_inv):
    """PI(z) via the barycentric formula with batch inversion
    (reference src/prover/proof.rs:540-591); input is sparse
    [(index, value)] pairs."""
    numerator = (pow(point, n, R_MOD) - 1) % R_MOD * n_inv % R_MOD
    nz = [(i, ev) for i, ev in sparse_evals if ev != 0]
    denoms = [(pow(generator_inv, i, R_MOD) * point - 1) % R_MOD
              for i, _ in nz]
    denoms = fr_batch_inv(denoms)
    acc = 0
    for (i, ev), d in zip(nz, denoms):
        acc = (acc + ev * d) % R_MOD
    return acc * numerator % R_MOD


def _flatten_aggregate(transcript, evals, comms, witness_comm):
    """AggregateProof::flatten (reference src/commitment_scheme.rs:107-153):
    fold evaluations and commitments by powers of a fresh v_challenge."""
    v = transcript.challenge_scalar(b"v_challenge")
    powers = [1]
    for _ in range(len(evals) - 1):
        powers.append(powers[-1] * v % R_MOD)
    flat_comm = bls.g1_msm(comms, powers)
    flat_eval = sum(e * p % R_MOD for e, p in zip(evals, powers)) % R_MOD
    return dict(commitment_to_witness=witness_comm,
                evaluated_point=flat_eval,
                commitment_to_polynomial=flat_comm)


def _batch_check(opening_key, points, proofs, transcript) -> bool:
    """2-proof batched KZG check ending in one 2-pair Miller loop
    (reference src/commitment_scheme.rs:24-66)."""
    from ..curves.pairing import multi_pairing_is_one

    u = transcript.challenge_scalar(b"batch")
    powers = [1]
    for _ in range(len(proofs) - 1):
        powers.append(powers[-1] * u % R_MOD)

    # two MSMs instead of per-term scalar muls (same fold:
    #   total_w = sum u^i w_i
    #   total_c = sum u^i c_i + sum u^i z_i w_i - (sum u^i ev_i) g )
    g_multiplier = 0
    c_pts, c_wts = [], []
    w_pts, w_wts = [], []
    for proof, u_pow, point in zip(proofs, powers, points):
        c_pts.append(proof["commitment_to_polynomial"])
        c_wts.append(u_pow)
        c_pts.append(proof["commitment_to_witness"])
        c_wts.append(u_pow * point % R_MOD)
        w_pts.append(proof["commitment_to_witness"])
        w_wts.append(u_pow)
        g_multiplier = (g_multiplier
                        + u_pow * proof["evaluated_point"]) % R_MOD
    c_pts.append(opening_key.g)
    c_wts.append((-g_multiplier) % R_MOD)
    total_c = bls.g1_msm(c_pts, c_wts)
    total_w = bls.g1_msm(w_pts, w_wts)

    return multi_pairing_is_one([
        (bls.g1_neg(total_w), opening_key.beta_h),
        (total_c, opening_key.h),
    ])
