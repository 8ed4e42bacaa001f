"""TurboPlonk gate-family formulas (quotient terms + linearization scalars).

The reference keeps these in the unmounted `zksnarks` crate; the formulas
here are re-derived from the Aztec/dusk TurboPlonk width-4 spec and pinned by

  (a) exhaustive truth-table tests (logic quads, ECC group law) in
      tests/test_widgets.py, and
  (b) the t_eval reconstruction identity the mounted verifier computes
      (reference src/prover/proof.rs:386-440), which ties prover and
      verifier formulas together end-to-end.

Quotient-term signatures mirror the per-family `compute_quotient_i` calls at
reference src/prover/quotient_poly.rs:165-259; linearization scalars mirror
`linearize` at src/prover/linearization_poly.rs:161-222 and the verifier-side
(scalars, points) form at src/prover/proof.rs:479-505.

Every formula is written against a minimal ops backend:
    ops.add(a, b), ops.sub(a, b), ops.mul(a, b), ops.scalar(int)
so the SAME code runs on host ints (oracle) and on the device engine's
batched limb tensors (broadcasting scalars against 8n evaluation arrays).
"""

from __future__ import annotations

from .constants import R_MOD, JUBJUB_D, PERM_K1, PERM_K2, PERM_K3


class HostOps:
    """Canonical-int backend."""
    @staticmethod
    def add(a, b):
        return (a + b) % R_MOD

    @staticmethod
    def sub(a, b):
        return (a - b) % R_MOD

    @staticmethod
    def mul(a, b):
        return a * b % R_MOD

    @staticmethod
    def scalar(v):
        return v % R_MOD


def _delta(ops, f):
    """f (f-1) (f-2) (f-3) — the base-4 digit check."""
    one = ops.scalar(1)
    two = ops.scalar(2)
    three = ops.scalar(3)
    return ops.mul(
        ops.mul(f, ops.sub(f, one)),
        ops.mul(ops.sub(f, two), ops.sub(f, three)))


def _delta_xor_and(ops, a, b, w, c, q_c):
    """The quad logic identity (AND when q_c=+1, XOR when q_c=-1):
       q_c * [9c - 3(a+b)] + 3(a+b+c) - 2F = 0
       F = w(w(4w - 18(a+b) + 81) + 18(a^2+b^2) - 81(a+b) + 83)
    with w = a*b enforced separately.  Verified exhaustively over all 16
    quad pairs in tests/test_widgets.py."""
    s = lambda v: ops.scalar(v)
    a_plus_b = ops.add(a, b)
    f = ops.mul(w, ops.add(
        ops.mul(w, ops.add(ops.sub(ops.mul(s(4), w),
                                   ops.mul(s(18), a_plus_b)), s(81))),
        ops.add(ops.sub(ops.mul(s(18), ops.add(ops.mul(a, a), ops.mul(b, b))),
                        ops.mul(s(81), a_plus_b)), s(83))))
    e = ops.sub(ops.mul(s(3), ops.add(a_plus_b, c)), ops.mul(s(2), f))
    bterm = ops.mul(q_c, ops.sub(ops.mul(s(9), c), ops.mul(s(3), a_plus_b)))
    return ops.add(bterm, e)


# ---------------------------------------------------------------------------
# Quotient terms (per evaluation point of the 8n coset)
# ---------------------------------------------------------------------------

def arithmetic_quotient(ops, q_m, q_l, q_r, q_o, q_c, q_4, q_arith,
                        a, b, c, d):
    acc = ops.mul(ops.mul(a, b), q_m)
    acc = ops.add(acc, ops.mul(a, q_l))
    acc = ops.add(acc, ops.mul(b, q_r))
    acc = ops.add(acc, ops.mul(c, q_o))
    acc = ops.add(acc, ops.mul(d, q_4))
    acc = ops.add(acc, q_c)
    return ops.mul(acc, q_arith)


def range_quotient(ops, q_range, sep, a, b, c, d, d_next):
    four = ops.scalar(4)
    kappa = ops.mul(sep, sep)
    kappa_sq = ops.mul(kappa, kappa)
    kappa_cu = ops.mul(kappa_sq, kappa)
    b1 = _delta(ops, ops.sub(c, ops.mul(four, d)))
    b2 = ops.mul(_delta(ops, ops.sub(b, ops.mul(four, c))), kappa)
    b3 = ops.mul(_delta(ops, ops.sub(a, ops.mul(four, b))), kappa_sq)
    b4 = ops.mul(_delta(ops, ops.sub(d_next, ops.mul(four, a))), kappa_cu)
    total = ops.add(ops.add(b1, b2), ops.add(b3, b4))
    return ops.mul(ops.mul(total, q_range), sep)


def logic_quotient(ops, q_logic, q_c, sep,
                   a, a_next, b, b_next, c, d, d_next):
    four = ops.scalar(4)
    kappa = ops.mul(sep, sep)
    kappa_sq = ops.mul(kappa, kappa)
    kappa_cu = ops.mul(kappa_sq, kappa)
    kappa_qu = ops.mul(kappa_cu, kappa)
    qa = ops.sub(a_next, ops.mul(four, a))   # operand-a quad
    qb = ops.sub(b_next, ops.mul(four, b))   # operand-b quad
    qd = ops.sub(d_next, ops.mul(four, d))   # output quad
    w = c                                    # witnessed product quad
    c0 = _delta(ops, qa)
    c1 = ops.mul(_delta(ops, qb), kappa)
    c2 = ops.mul(_delta(ops, qd), kappa_sq)
    c3 = ops.mul(ops.sub(w, ops.mul(qa, qb)), kappa_cu)
    c4 = ops.mul(_delta_xor_and(ops, qa, qb, w, qd, q_c), kappa_qu)
    total = ops.add(ops.add(ops.add(c0, c1), ops.add(c2, c3)), c4)
    return ops.mul(ops.mul(total, q_logic), sep)


def fixed_base_quotient(ops, q_fixed, q_l, q_r, q_c, sep,
                        a, a_next, b, b_next, c, d, d_next):
    """Fixed-base scalar-mul gate: wires per reference src/lib.rs:502-510 —
    a = acc_x, b = acc_y, o = xy_alpha, d = accumulated_bit;
    q_l = x_beta, q_r = y_beta, q_c = xy_beta (precomputed point data)."""
    one = ops.scalar(1)
    two = ops.scalar(2)
    edwards_d = ops.scalar(JUBJUB_D)
    kappa = ops.mul(sep, sep)
    kappa_sq = ops.mul(kappa, kappa)
    kappa_cu = ops.mul(kappa_sq, kappa)

    x_beta, y_beta = q_l, q_r
    acc_x, acc_x_next = a, a_next
    acc_y, acc_y_next = b, b_next
    xy_alpha = c

    bit = ops.sub(d_next, ops.mul(two, d))   # wNAF digit
    bit_consistency = ops.mul(
        ops.mul(bit, ops.sub(bit, one)), ops.add(bit, one))

    y_alpha = ops.add(ops.mul(ops.mul(bit, bit), ops.sub(y_beta, one)), one)
    x_alpha = ops.mul(x_beta, bit)

    xy_consistency = ops.mul(ops.sub(ops.mul(bit, q_c), xy_alpha), kappa)

    acc_xy = ops.mul(ops.mul(xy_alpha, acc_x), acc_y)
    # x-acc: x3 (1 + d xy_alpha acc_x acc_y) = x_alpha acc_y + y_alpha acc_x
    x_lhs = ops.add(acc_x_next,
                    ops.mul(ops.mul(acc_x_next, acc_xy), edwards_d))
    x_rhs = ops.add(ops.mul(x_alpha, acc_y), ops.mul(y_alpha, acc_x))
    x_acc = ops.mul(ops.sub(x_lhs, x_rhs), kappa_sq)
    # y-acc (a=-1): y3 (1 - d xy_alpha acc_x acc_y) = y_alpha acc_y + x_alpha acc_x
    y_lhs = ops.sub(acc_y_next,
                    ops.mul(ops.mul(acc_y_next, acc_xy), edwards_d))
    y_rhs = ops.add(ops.mul(y_alpha, acc_y), ops.mul(x_alpha, acc_x))
    y_acc = ops.mul(ops.sub(y_lhs, y_rhs), kappa_cu)

    checks = ops.add(ops.add(bit_consistency, xy_consistency),
                     ops.add(x_acc, y_acc))
    return ops.mul(ops.mul(checks, q_fixed), sep)


def variable_base_quotient(ops, q_var, sep,
                           a, a_next, b, b_next, c, d, d_next):
    """Variable-base addition gate: gate i holds (x1, y1, x2, y2) in
    (a, b, o, d); gate i+1 holds (x3, y3, x1*y2) in (a, b, d)
    (reference src/lib.rs:833-849)."""
    edwards_d = ops.scalar(JUBJUB_D)
    kappa = ops.mul(sep, sep)
    kappa_sq = ops.mul(kappa, kappa)

    x_1, y_1, x_2, y_2 = a, b, c, d
    x_3, y_3, x1_y2 = a_next, b_next, d_next

    xy_consistency = ops.sub(ops.mul(x_1, y_2), x1_y2)
    y1_x2 = ops.mul(y_1, x_2)
    y1_y2 = ops.mul(y_1, y_2)
    x1_x2 = ops.mul(x_1, x_2)
    d_xy = ops.mul(ops.mul(edwards_d, x1_y2), y1_x2)

    x3_lhs = ops.add(x1_y2, y1_x2)
    x3_rhs = ops.add(x_3, ops.mul(x_3, d_xy))
    x3_consistency = ops.mul(ops.sub(x3_lhs, x3_rhs), kappa)

    y3_lhs = ops.add(y1_y2, x1_x2)
    y3_rhs = ops.sub(y_3, ops.mul(y_3, d_xy))
    y3_consistency = ops.mul(ops.sub(y3_lhs, y3_rhs), kappa_sq)

    total = ops.add(xy_consistency, ops.add(x3_consistency, y3_consistency))
    return ops.mul(ops.mul(total, q_var), sep)


def permutation_quotient(ops, x_i, sigma1, sigma2, sigma3, sigma4,
                         a, b, c, d, z, z_next,
                         alpha, l1_alpha_sq, beta, gamma):
    """Copy-constraint quotient term (reference call at
    src/prover/quotient_poly.rs:247-259): identity-range product times z,
    minus sigma-range product times z(next), plus (z-1) L1 alpha^2."""
    k1 = ops.scalar(PERM_K1)
    k2 = ops.scalar(PERM_K2)
    k3 = ops.scalar(PERM_K3)
    bx = ops.mul(beta, x_i)
    t1 = ops.mul(ops.mul(
        ops.mul(ops.add(ops.add(a, bx), gamma),
                ops.add(ops.add(b, ops.mul(k1, bx)), gamma)),
        ops.mul(ops.add(ops.add(c, ops.mul(k2, bx)), gamma),
                ops.add(ops.add(d, ops.mul(k3, bx)), gamma))),
        ops.mul(z, alpha))
    t2 = ops.mul(ops.mul(
        ops.mul(ops.add(ops.add(a, ops.mul(beta, sigma1)), gamma),
                ops.add(ops.add(b, ops.mul(beta, sigma2)), gamma)),
        ops.mul(ops.add(ops.add(c, ops.mul(beta, sigma3)), gamma),
                ops.add(ops.add(d, ops.mul(beta, sigma4)), gamma))),
        ops.mul(z_next, alpha))
    t3 = ops.mul(ops.sub(z, ops.scalar(1)), l1_alpha_sq)
    return ops.add(ops.sub(t1, t2), t3)


# ---------------------------------------------------------------------------
# Linearization scalars: the scalar weight each committed polynomial receives
# in r(X).  The prover applies them to coefficient arrays; the verifier
# applies the SAME scalars to the corresponding commitments — one source of
# truth for both (prover: linearization_poly.rs trace; verifier:
# proof.rs:457-527 trace).
# ---------------------------------------------------------------------------

def linearization_scalars(evals: dict, challenges: dict,
                          l1_eval: int, z_challenge: int) -> list:
    """Returns [(poly_key, scalar)] with poly_key in
    {q_m,q_l,q_r,q_o,q_4,q_c,q_range,q_logic,q_fixed_group_add,
     q_variable_group_add,z_poly,s_sigma_4}."""
    ops = HostOps
    e = evals
    ch = challenges
    a, b, c, d = e["a_eval"], e["b_eval"], e["c_eval"], e["d_eval"]
    a_n, b_n, d_n = e["a_next_eval"], e["b_next_eval"], e["d_next_eval"]
    q_arith = e["q_arith_eval"]
    out = []

    # arithmetic (linearize at linearization_poly.rs:161-167 equivalent)
    out.append(("q_m", a * b % R_MOD * q_arith % R_MOD))
    out.append(("q_l", a * q_arith % R_MOD))
    out.append(("q_r", b * q_arith % R_MOD))
    out.append(("q_o", c * q_arith % R_MOD))
    out.append(("q_4", d * q_arith % R_MOD))
    out.append(("q_c", q_arith))

    one = 1

    # range: same digit combination evaluated at z
    sep = ch["range_sep"]
    r_term = range_quotient(ops, one, sep, a, b, c, d, d_n)
    out.append(("q_range", r_term))

    # logic: uses the evaluated q_c
    sep = ch["logic_sep"]
    l_term = logic_quotient(ops, one, e["q_c_eval"], sep,
                            a, a_n, b, b_n, c, d, d_n)
    out.append(("q_logic", l_term))

    # fixed-base: uses evaluated q_l, q_r, q_c
    sep = ch["fixed_base_sep"]
    f_term = fixed_base_quotient(ops, one, e["q_l_eval"], e["q_r_eval"],
                                 e["q_c_eval"], sep,
                                 a, a_n, b, b_n, c, d, d_n)
    out.append(("q_fixed_group_add", f_term))

    # variable-base
    sep = ch["var_base_sep"]
    v_term = variable_base_quotient(ops, one, sep, a, a_n, b, b_n, c, d, d_n)
    out.append(("q_variable_group_add", v_term))

    # permutation
    alpha, beta, gamma = ch["alpha"], ch["beta"], ch["gamma"]
    z_ch = z_challenge
    bz = beta * z_ch % R_MOD
    prod4 = ((a + bz + gamma) % R_MOD
             * ((b + PERM_K1 * bz + gamma) % R_MOD) % R_MOD
             * ((c + PERM_K2 * bz + gamma) % R_MOD) % R_MOD
             * ((d + PERM_K3 * bz + gamma) % R_MOD) % R_MOD)
    z_scalar = (prod4 * alpha + l1_eval * alpha % R_MOD * alpha) % R_MOD
    out.append(("z_poly", z_scalar))

    prod3 = ((a + beta * e["s_sigma_1_eval"] + gamma) % R_MOD
             * ((b + beta * e["s_sigma_2_eval"] + gamma) % R_MOD) % R_MOD
             * ((c + beta * e["s_sigma_3_eval"] + gamma) % R_MOD) % R_MOD)
    sigma4_scalar = (R_MOD - prod3 * beta % R_MOD
                     * e["perm_eval"] % R_MOD * alpha % R_MOD) % R_MOD
    out.append(("s_sigma_4", sigma4_scalar))

    return out
