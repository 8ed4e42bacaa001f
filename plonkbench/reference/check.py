"""The comparison that decides `correct`: the SRS, the verification key and
each sampled proof, worked out again from the seed, the circuit and the
request's inputs.

The benchmark knows the SRS secret tau: it is the first draw of the seeded
ChaCha stream that `PlonkParams.setup_device` consumes.  So every commitment
to a polynomial p is [p(tau)] G, and p(tau) needs no transform and no MSM: a
polynomial given by its values over the domain H (size n, generator w)
evaluates at any x through the Lagrange basis

    L_j(x) = w^j (x^n - 1) / (n (x - w^j)),    p(x) = sum_j p_j L_j(x),

and a blinded polynomial adds (b_0 + b_1 x + ...)(x^n - 1).  L(x w) is L(x)
shifted by one place, so the next-gate values come from the same vector.
The vectors (the columns, the Lagrange vectors, the grand product) are
held in plain PyTorch by fr_limbs.py, on the card in the benchmark.
Per proof the reference computes:

  * the four wire commitments and z's, from the witness, the blinders and
    the grand product it forms itself;
  * t(tau) = N(tau) / Z_H(tau) from the gate and permutation formulas, held
    against the proof's chunks as [t_low] + tau^n [t_mid] + tau^2n [t_high]
    + tau^3n [t_4]: each chunk alone needs t's coefficients (an 8n-point
    transform) that the host cannot form within a run, so the chunks are
    checked in that combination and, below, in the one the opening at z
    takes;
  * the challenges, from its own transcript (which absorbs its own values
    and the proof's four t chunks);
  * the 16 evaluations at z and z w, t(z) = N(z) / Z_H(z) and r(z);
  * [W_zw] exactly, and (tau - z) [W_z] = [quot(tau)] + [rest] - agg(z) G,
    with [quot(tau)] the proof's chunks folded by powers of z^n.

Every number compared is a count of mismatches, with the limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bls, widgets
from .chacha import ChaCha12Rng, fr_random
from .composer import FastPlonk, Plonk
from .constants import R_MOD
from .fr_limbs import FrVec
from .host import fr_root_of_unity
from .permutation import KS
from .transcript import PlonkTranscript

G1 = bls.G1_GENERATOR
G2 = bls.G2_GENERATOR

SELECTOR_NAMES = ("q_m", "q_l", "q_r", "q_o", "q_c", "q_4", "q_arith",
                  "q_range", "q_logic", "q_fixed_group_add",
                  "q_variable_group_add")
SIGMA_NAMES = ("s_sigma_1", "s_sigma_2", "s_sigma_3", "s_sigma_4")
# the proof's commitments and evaluations, by the names of proving/proof.py
COMMITMENTS = ("a_comm", "b_comm", "c_comm", "d_comm", "z_comm",
               "t_low_comm", "t_mid_comm", "t_high_comm", "t_4_comm",
               "w_z_chall_comm", "w_z_chall_w_comm")
EVAL_TRANSCRIPT_ORDER = (
    "a_eval", "b_eval", "c_eval", "d_eval", "a_next_eval", "b_next_eval",
    "d_next_eval", "s_sigma_1_eval", "s_sigma_2_eval", "s_sigma_3_eval",
    "q_arith_eval", "q_c_eval", "q_l_eval", "q_r_eval", "perm_eval")
EVALUATIONS = EVAL_TRANSCRIPT_ORDER + ("r_poly_eval",)
# the numbers compared, each with the limit 0
CHECKS = ("proofs_failed", "srs_mismatch", "vk_mismatch", "commit_mismatch",
          "quotient_mismatch", "eval_mismatch", "opening_mismatch")


def next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


def derive_tau(srs_seed: int) -> int:
    """The SRS secret: the first Fr draw of ChaCha12Rng.seed_from_u64."""
    return fr_random(ChaCha12Rng.seed_from_u64(srs_seed))


def blind(coeffs, x: int, zh: int) -> int:
    """(b_0 + b_1 x + ...)(x^n - 1), with zh = x^n - 1."""
    acc = 0
    for b in reversed(coeffs):
        acc = (acc * x + b) % R_MOD
    return acc * zh % R_MOD


def g1_lin(terms):
    """sum s_i P_i over (scalar, affine point) pairs."""
    acc = None
    for s, p in terms:
        acc = bls.g1_add(acc, bls.g1_mul(p, s))
    return acc


def numerator(x, sel, sig, w, wn, z, zn, pi, l1, ch):
    """The quotient's numerator at x: the gate families and the
    permutation term of proving/prover.py::compute_quotient_host for one
    point (w, wn: wires a, b, c, d at x and x w)."""
    ops = widgets.HostOps
    a, b, c, d = w
    a_n, b_n, _, d_n = wn
    t = widgets.arithmetic_quotient(
        ops, sel["q_m"], sel["q_l"], sel["q_r"], sel["q_o"], sel["q_c"],
        sel["q_4"], sel["q_arith"], a, b, c, d)
    t = (t + pi) % R_MOD
    t += widgets.range_quotient(ops, sel["q_range"], ch["range_sep"],
                                a, b, c, d, d_n)
    t += widgets.logic_quotient(ops, sel["q_logic"], sel["q_c"],
                                ch["logic_sep"], a, a_n, b, b_n, c, d, d_n)
    t += widgets.fixed_base_quotient(
        ops, sel["q_fixed_group_add"], sel["q_l"], sel["q_r"], sel["q_c"],
        ch["fixed_base_sep"], a, a_n, b, b_n, c, d, d_n)
    t += widgets.variable_base_quotient(
        ops, sel["q_variable_group_add"], ch["var_base_sep"],
        a, a_n, b, b_n, c, d, d_n)
    t += widgets.permutation_quotient(
        ops, x, sig[0], sig[1], sig[2], sig[3], a, b, c, d, z, zn,
        ch["alpha"], l1 * ch["alpha"] % R_MOD * ch["alpha"] % R_MOD,
        ch["beta"], ch["gamma"])
    return t % R_MOD


class CircuitKey:
    """What the reference derives once per run from the circuit and tau:
    the gates, the wire columns, the sigma cycles, every key polynomial at
    tau, and the verification key's commitments."""

    def __init__(self, circuit, tau: int, device="cpu",
                 label: bytes = b"plonk"):
        self.F = F = FrVec(device)
        cs = Plonk.initialize()
        circuit.synthesize(cs)
        self.m = m = cs.m()
        self.n = n = next_pow2(m)
        self.k = n.bit_length() - 1
        self.omega = omega = fr_root_of_unity(self.k)
        self.roots = F.powers(omega, n)
        self.n_witness = len(cs.witness)
        # the zero-padded tail reads a sentinel zero past the witness
        self.wire_idx = torch.tensor(
            [list(col) + [self.n_witness] * (n - len(col))
             for col in cs.wire_cols], device=F.device)
        cons = cs.constraints
        self.sel = {}
        for name in SELECTOR_NAMES:
            attr = "q_d" if name == "q_4" else name
            self.sel[name] = F.upload([getattr(c, attr) % R_MOD
                                       for c in cons] + [0] * (n - m))
        ks = torch.cat([F.const(v) for v in KS], dim=1)
        self.sig = []
        for s in cs.perm.compute_sigma_permutations(n):
            cg = torch.from_numpy(np.array(s, dtype=np.int64)).to(F.device)
            self.sig.append(F.mul(ks[:, cg[:, 0]], self.roots[:, cg[:, 1]]))
        self.tau = tau
        self.tau_n = pow(tau, n, R_MOD)
        self.zh_tau = (self.tau_n - 1) % R_MOD
        self.L_tau = self.lagrange(tau)
        self.l1_tau = F.to_int(self.L_tau[:, :1])
        self.sel_tau = {k: F.dot(v, self.L_tau) for k, v in self.sel.items()}
        self.sig_tau = [F.dot(s, self.L_tau) for s in self.sig]
        self.vk = {name: bls.g1_mul(G1, self.sel_tau[name])
                   for name in SELECTOR_NAMES}
        self.vk.update({name: bls.g1_mul(G1, v)
                        for name, v in zip(SIGMA_NAMES, self.sig_tau)})
        self.base = PlonkTranscript.base(label, self.vk, m)

    def lagrange(self, x: int) -> torch.Tensor:
        """[L_j(x)] over the domain."""
        F, n = self.F, self.n
        c = (pow(x, n, R_MOD) - 1) * pow(n, -1, R_MOD) % R_MOD
        if c == 0:
            raise ValueError("the point lies in the domain")
        inv = F.inv(F.sub(F.const(x), self.roots))
        return F.mul(F.mul(inv, self.roots), F.const(c))

    def at(self, col, basis, shift: int = 0) -> int:
        """sum_j col[(j + shift) % n] basis[j]: the column's polynomial at
        x (shift 0) or at x w (shift 1), for basis = L(x)."""
        if shift:
            basis = torch.roll(basis, shift, dims=1)
        return self.F.dot(col, basis)

    # -- set-up ----------------------------------------------------------

    def check_srs(self, powers: dict, h, beta_h) -> int:
        """powers {i: affine point} against tau^i G; h, beta_h against
        G2 and tau G2.  Returns the number of mismatches."""
        bad = sum(p != bls.g1_mul(G1, pow(self.tau, i, R_MOD))
                  for i, p in powers.items())
        bad += h != G2
        bad += beta_h != bls.g2_mul(G2, self.tau)
        return bad

    def check_vk(self, commitments: dict, n_field: int, n_inv: int,
                 generator: int, generator_inv: int, opening) -> int:
        """The verification key and the opening key (g, h, beta_h)."""
        bad = sum(commitments.get(k) != v for k, v in self.vk.items())
        bad += len(commitments) != len(self.vk)
        bad += n_field != self.m
        bad += n_inv != pow(self.n, -1, R_MOD)
        bad += generator != self.omega
        bad += generator_inv != pow(self.omega, -1, R_MOD)
        g, h, beta_h = opening
        bad += g != G1
        bad += h != G2
        bad += beta_h != bls.g2_mul(G2, self.tau)
        return bad

    # -- one proof -------------------------------------------------------

    def check_proof(self, circuit, blinder_seed: int, commitments: dict,
                    evaluations: dict, public_inputs) -> dict:
        """Mismatch counts of one proof, by kind (CHECKS[3:])."""
        F, n, R, at = self.F, self.n, R_MOD, self.at
        bad = dict.fromkeys(CHECKS[3:], 0)
        fs = FastPlonk.initialize()
        circuit.synthesize(fs)
        if len(fs.witness) != self.n_witness or fs.m() != self.m:
            raise ValueError("the request's circuit has another shape")
        wit = F.upload(fs.witness + [0])
        wires = [wit[:, self.wire_idx[c]] for c in range(4)]
        pi_pairs = sorted(fs.instance.items())
        bad["eval_mismatch"] += [v for _, v in pi_pairs] != \
            list(public_inputs)
        pi = torch.zeros_like(wires[0])
        if pi_pairs:
            idx = torch.tensor([j for j, _ in pi_pairs], device=F.device)
            pi[:, idx] = F.upload([v for _, v in pi_pairs])

        rng = ChaCha12Rng.seed_from_u64(blinder_seed)
        wb = [[fr_random(rng) for _ in range(2)] for _ in range(4)]
        tr = self.base.clone()
        for _, v in pi_pairs:
            tr.append_scalar(b"pi", v)

        # round 1: the wires at tau and tau w
        tau, zh = self.tau, self.zh_tau
        tau_w = tau * self.omega % R
        L = self.L_tau
        w_tau = [(at(wires[c], L) + blind(wb[c], tau, zh)) % R
                 for c in range(4)]
        w_tau_w = [(at(wires[c], L, 1) + blind(wb[c], tau_w, zh)) % R
                   for c in range(4)]
        for c, (label, field) in enumerate(zip(
                (b"a_w", b"b_w", b"c_w", b"d_w"), COMMITMENTS[:4])):
            want = bls.g1_mul(G1, w_tau[c])
            bad["commit_mismatch"] += commitments[field] != want
            tr.append_commitment(label, want)

        # round 2: the grand product over the domain
        beta = tr.challenge_scalar(b"beta")
        tr.append_scalar(b"beta", beta)
        gamma = tr.challenge_scalar(b"gamma")
        zb = [fr_random(rng) for _ in range(3)]
        bx = F.mul(self.roots, F.const(beta))
        nums = dens = None
        for c in range(4):
            wg = F.add(wires[c], F.const(gamma))
            num = F.add(wg, F.mul(bx, F.const(KS[c])))
            den = F.add(wg, F.mul(self.sig[c], F.const(beta)))
            nums = num if nums is None else F.mul(nums, num)
            dens = den if dens is None else F.mul(dens, den)
        ratio = F.mul(nums[:, :n - 1], F.inv(dens[:, :n - 1]))
        zcol = torch.cat([F.const(1), F.prefix(ratio)], dim=1)
        z_tau = (at(zcol, L) + blind(zb, tau, zh)) % R
        z_tau_w = (at(zcol, L, 1) + blind(zb, tau_w, zh)) % R
        want = bls.g1_mul(G1, z_tau)
        bad["commit_mismatch"] += commitments["z_comm"] != want
        tr.append_commitment(b"z", want)

        # round 3: t(tau) against the proof's chunks
        ch = {"alpha": tr.challenge_scalar(b"alpha"),
              "beta": beta, "gamma": gamma}
        for key, label in (
                ("range_sep", b"range separation challenge"),
                ("logic_sep", b"logic separation challenge"),
                ("fixed_base_sep", b"fixed base separation challenge"),
                ("var_base_sep", b"variable base separation challenge")):
            ch[key] = tr.challenge_scalar(label)
        n_tau = numerator(tau, self.sel_tau, self.sig_tau, w_tau, w_tau_w,
                          z_tau, z_tau_w, at(pi, L), self.l1_tau, ch)
        t_tau = n_tau * pow(zh, -1, R) % R
        chunks = [commitments[f] for f in COMMITMENTS[5:9]]
        folded = g1_lin(zip((1, self.tau_n, pow(self.tau_n, 2, R),
                             pow(self.tau_n, 3, R)), chunks))
        bad["quotient_mismatch"] += folded != bls.g1_mul(G1, t_tau)
        for label, comm in zip((b"t_low", b"t_mid", b"t_high", b"t_4"),
                               chunks):
            tr.append_commitment(label, comm)

        # round 4: the evaluations at z and z w
        z = tr.challenge_scalar(b"z_challenge")
        zw = z * self.omega % R
        zn = pow(z, n, R)
        zh_z = (zn - 1) % R
        Lz = self.lagrange(z)
        w_z = [(at(wires[c], Lz) + blind(wb[c], z, zh_z)) % R
               for c in range(4)]
        w_zw = [(at(wires[c], Lz, 1) + blind(wb[c], zw, zh_z)) % R
                for c in range(4)]
        sel_z = {k: at(v, Lz) for k, v in self.sel.items()}
        sig_z = [at(s, Lz) for s in self.sig]
        z_z = (at(zcol, Lz) + blind(zb, z, zh_z)) % R
        z_zw = (at(zcol, Lz, 1) + blind(zb, zw, zh_z)) % R
        ev = {"a_eval": w_z[0], "b_eval": w_z[1], "c_eval": w_z[2],
              "d_eval": w_z[3], "a_next_eval": w_zw[0],
              "b_next_eval": w_zw[1], "d_next_eval": w_zw[3],
              "s_sigma_1_eval": sig_z[0], "s_sigma_2_eval": sig_z[1],
              "s_sigma_3_eval": sig_z[2], "q_arith_eval": sel_z["q_arith"],
              "q_c_eval": sel_z["q_c"], "q_l_eval": sel_z["q_l"],
              "q_r_eval": sel_z["q_r"], "perm_eval": z_zw}
        n_z = numerator(z, sel_z, sig_z, w_z, w_zw, z_z, z_zw, at(pi, Lz),
                        F.to_int(Lz[:, :1]), ch)
        t_eval = n_z * pow(zh_z, -1, R) % R
        l1_eval = zh_z * pow(n * (z - 1) % R, -1, R) % R
        at_z = dict(sel_z, z_poly=z_z, s_sigma_4=sig_z[3])
        at_tau = dict(self.sel_tau, z_poly=z_tau, s_sigma_4=self.sig_tau[3])
        scalars = widgets.linearization_scalars(ev, ch, l1_eval, z)
        ev["r_poly_eval"] = sum(s * at_z[k] for k, s in scalars) % R
        r_tau = sum(s * at_tau[k] for k, s in scalars) % R
        bad["eval_mismatch"] += sum(evaluations.get(k) != ev[k]
                                    for k in EVALUATIONS)
        bad["eval_mismatch"] += len(evaluations) != len(EVALUATIONS)
        for key in EVAL_TRANSCRIPT_ORDER:
            tr.append_scalar(key.encode(), ev[key])
        tr.append_scalar(b"t_eval", t_eval)
        tr.append_scalar(b"r_eval", ev["r_poly_eval"])

        # round 5: the two openings
        v1 = tr.challenge_scalar(b"v_challenge")
        v2 = tr.challenge_scalar(b"v_challenge")
        rest_z = [ev["r_poly_eval"], *w_z, *sig_z[:3]]
        rest_tau = [r_tau, *w_tau, *self.sig_tau[:3]]
        agg_z, agg_tau, pw = t_eval, 0, 1
        for ez, et in zip(rest_z, rest_tau):
            pw = pw * v1 % R
            agg_z = (agg_z + pw * ez) % R
            agg_tau = (agg_tau + pw * et) % R
        quot = g1_lin(zip((1, zn, zn * zn % R, pow(zn, 3, R)), chunks))
        lhs = bls.g1_mul(commitments["w_z_chall_comm"], (tau - z) % R)
        rhs = bls.g1_add(quot, bls.g1_mul(G1, agg_tau - agg_z))
        bad["opening_mismatch"] += lhs != rhs
        sh_zw = [z_zw, w_zw[0], w_zw[1], w_zw[3]]
        sh_tau = [z_tau, w_tau[0], w_tau[1], w_tau[3]]
        agg2, pw = 0, 1
        for ez, et in zip(sh_zw, sh_tau):
            agg2 = (agg2 + pw * (et - ez)) % R
            pw = pw * v2 % R
        want = bls.g1_mul(G1, agg2 * pow((tau - zw) % R, -1, R))
        bad["commit_mismatch"] += commitments["w_z_chall_w_comm"] != want
        return bad
