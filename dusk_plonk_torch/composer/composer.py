"""The Plonk composer: witness allocation, gate appending, public-input
bookkeeping, and the gadget library.

Behavioral re-implementation of reference src/lib.rs (struct Plonk + gadget
methods). Witness values are canonical Fr ints; wires are integer indices.
Gate layouts (which wires/selectors each gadget emits, and in which order)
are part of circuit identity and follow the reference exactly; the gate
*formulas* they satisfy live in proving/widgets.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import R_MOD
from ..curves import jubjub as jj
from .constraint import Constraint
from .permutation import Permutation


class Error(Exception):
    """zksnarks::error::Error equivalents (variants used by the reference:
    UnsupportedWNAF2k src/lib.rs:452, InconsistentPublicInputsLen
    src/verifier.rs:52, ProofVerificationError src/prover/proof.rs:379,
    PairingCheckFailure src/commitment_scheme.rs:63)."""


class UnsupportedWNAF2k(Error):
    pass


class InconsistentPublicInputsLen(Error):
    pass


class ProofVerificationError(Error):
    pass


class PairingCheckFailure(Error):
    pass


@dataclass(frozen=True)
class WitnessPoint:
    """A JubJub point allocated in the circuit (reference
    src/gadget/ecc.rs:12-32)."""
    x: int
    y: int


class Plonk:
    """Constraint system (reference `Plonk<C>` at src/lib.rs:102-115)."""

    ZERO = 0
    ONE = 1

    def __init__(self):
        self.constraints: list[Constraint] = []
        self.instance: dict[int, int] = {}
        self.witness: list[int] = []
        self.perm = Permutation()
        # columnar wire-index mirror of self.constraints, filled by
        # append_custom_gate: the prover packs 4*n wire VALUES per proof,
        # and per-constraint attribute walks cost ~0.1 s at 2^16 gates
        self.wire_cols = ([], [], [], [])          # w_a, w_b, w_o, w_d

    # -- core (src/lib.rs:121-267) -------------------------------------------

    @classmethod
    def initialize(cls) -> "Plonk":
        slf = cls()
        zero = slf.append_witness(0)
        one = slf.append_witness(1)
        slf.assert_equal_constant(zero, 0, None)
        slf.assert_equal_constant(one, 1, None)
        slf.append_dummy_gates()
        slf.append_dummy_gates()
        return slf

    @property
    def IDENTITY(self) -> WitnessPoint:
        return WitnessPoint(self.ZERO, self.ONE)

    def m(self) -> int:
        return len(self.constraints)

    def value(self, wire: int) -> int:
        return self.witness[wire]

    def __getitem__(self, wire: int) -> int:
        return self.witness[wire]

    def append_witness(self, value) -> int:
        n = len(self.witness)
        self.perm.new_witness()
        self.witness.append(int(value) % R_MOD)
        return n

    def append_custom_gate(self, c: Constraint) -> None:
        n = len(self.constraints)
        self.constraints.append(c)
        if c.public_input is not None:
            self.instance[n] = c.public_input
        wa, wb, wo, wd = self.wire_cols
        wa.append(c.w_a)
        wb.append(c.w_b)
        wo.append(c.w_o)
        wd.append(c.w_d)
        self.perm.add_witnesses_to_map(c.w_a, c.w_b, c.w_o, c.w_d, n)

    def wire_values(self, n: int) -> list[int]:
        """Flat [a values.. 0-pad to n, b.., o.., d..] for the round-1
        wire tables (reference gathers per gate, src/prover.rs:109-119)."""
        w = self.witness
        out = []
        for col in self.wire_cols:
            out.extend([w[i] for i in col])
            out.extend([0] * (n - len(col)))
        return out

    def append_gate(self, c: Constraint) -> None:
        """Arithmetic gate: q_m·a·b + q_l·a + q_r·b + q_o·o + q_4·d + q_c
        + PI = 0 (src/lib.rs:542-550)."""
        self.append_custom_gate(Constraint.arithmetic(c))

    def append_evaluated_output(self, s: Constraint) -> int | None:
        a = self.witness[s.w_a]
        b = self.witness[s.w_b]
        d = self.witness[s.w_d]
        pi = s.public_input or 0
        x = (s.q_m * a % R_MOD * b + s.q_l * a + s.q_r * b
             + s.q_d * d + s.q_c + pi) % R_MOD
        y = s.q_o
        if y == 0:
            return None
        # fast paths for q_o = ±1 (the reference has the same special
        # cases, src/lib.rs:555-602; avoids a modular inverse per gate)
        if y == R_MOD - 1:
            o = x
        elif y == 1:
            o = (R_MOD - x) % R_MOD
        else:
            o = (R_MOD - x) * pow(y, -1, R_MOD) % R_MOD
        return self.append_witness(o)

    def append_dummy_gates(self) -> None:
        """Blinding/dummy gates with the reference's exact witness values
        6, 1, 7, -20 and selectors (src/lib.rs:606-640)."""
        six = self.append_witness(6)
        one = self.append_witness(1)
        seven = self.append_witness(7)
        min_twenty = self.append_witness(R_MOD - 20)

        c = (Constraint().mult(1).left(2).right(3).fourth(1).constant(4)
             .output(4).a(six).b(seven).d(one).o(min_twenty))
        self.append_gate(c)

        c = (Constraint().mult(1).left(1).right(1).constant(127).output(1)
             .a(min_twenty).b(six).o(seven))
        self.append_gate(c)

    # -- public inputs ---------------------------------------------------------

    def public_input_indexes(self) -> list[int]:
        return sorted(self.instance.keys())

    def instance_values(self) -> list[int]:
        return [self.instance[i] for i in self.public_input_indexes()]

    @staticmethod
    def dense_public_inputs(indexes, values, size) -> list[int]:
        dense = [0] * size
        for idx, v in zip(indexes, values):
            dense[idx] = v
        return dense

    # -- scalar / point allocation helpers ------------------------------------

    def append_constant(self, constant) -> int:
        constant = int(constant) % R_MOD
        w = self.append_witness(constant)
        self.assert_equal_constant(w, constant, None)
        return w

    def append_point(self, affine) -> WitnessPoint:
        x = self.append_witness(affine[0])
        y = self.append_witness(affine[1])
        return WitnessPoint(x, y)

    def append_constant_point(self, affine) -> WitnessPoint:
        x = self.append_constant(affine[0])
        y = self.append_constant(affine[1])
        return WitnessPoint(x, y)

    def append_public_point(self, affine) -> WitnessPoint:
        point = self.append_point(affine)
        self.assert_equal_constant(point.x, 0, (R_MOD - affine[0]) % R_MOD)
        self.assert_equal_constant(point.y, 0, (R_MOD - affine[1]) % R_MOD)
        return point

    def append_public(self, public) -> int:
        public = int(public) % R_MOD
        w = self.append_witness(public)
        self.assert_equal_constant(w, 0, (R_MOD - public) % R_MOD)
        return w

    # -- equality assertions ---------------------------------------------------

    def assert_equal(self, a: int, b: int) -> None:
        c = Constraint().left(1).right(R_MOD - 1).a(a).b(b)
        self.append_gate(c)

    def assert_equal_constant(self, a: int, constant, public) -> None:
        constant = int(constant) % R_MOD
        c = Constraint().left(1).constant((R_MOD - constant) % R_MOD).a(a)
        if public is not None:
            c = c.public(public)
        self.append_gate(c)

    def assert_equal_point(self, a: WitnessPoint, b: WitnessPoint) -> None:
        self.assert_equal(a.x, b.x)
        self.assert_equal(a.y, b.y)

    def assert_equal_public_point(self, point: WitnessPoint, public) -> None:
        self.assert_equal_constant(point.x, 0, (R_MOD - public[0]) % R_MOD)
        self.assert_equal_constant(point.y, 0, (R_MOD - public[1]) % R_MOD)

    # -- arithmetic output gates ------------------------------------------------

    def _gate_with_output(self, s: Constraint) -> int:
        """Shared gate_add/gate_mul body: ONE private copy of the user's
        constraint, mutated in place (the chained-builder version copied
        the 16-field record four more times per gate — the dominant cost
        of witness synthesis at 2^16 gates, measured)."""
        c = s._copy()
        c.q_arith = 1
        c.q_o = R_MOD - 1
        o = self.append_evaluated_output(c)
        assert o is not None, "output selector is -1"
        c.w_o = o
        self.append_custom_gate(c)
        return o

    def gate_add(self, s: Constraint) -> int:
        return self._gate_with_output(s)

    def gate_mul(self, s: Constraint) -> int:
        return self._gate_with_output(s)

    # -- boolean / select / decomposition (src/lib.rs:852-1055) ------------------

    def component_boolean(self, a: int) -> None:
        c = (Constraint().mult(1).output(R_MOD - 1)
             .a(a).b(a).o(a).d(self.ZERO))
        self.append_gate(c)

    def component_decomposition(self, scalar: int, n_bits: int) -> list[int]:
        """2*N + 1 gates (src/lib.rs:877-910). Bits LSB-first."""
        assert 0 < n_bits <= 256
        value = self.witness[scalar]
        decomposition = []
        acc = self.ZERO
        for i in range(n_bits):
            bit = (value >> i) & 1
            d = self.append_witness(bit)
            decomposition.append(d)
            self.component_boolean(d)
            c = Constraint().left(pow(2, i, R_MOD)).right(1).a(d).b(acc)
            acc = self.gate_add(c)
        self.assert_equal(acc, scalar)
        return decomposition

    def component_select(self, bit: int, a: int, b: int) -> int:
        bit_times_a = self.gate_mul(Constraint().mult(1).a(bit).b(a))
        one_min_bit = self.gate_add(
            Constraint().left(R_MOD - 1).constant(1).a(bit))
        one_min_bit_b = self.gate_mul(
            Constraint().mult(1).a(one_min_bit).b(b))
        return self.gate_add(
            Constraint().left(1).right(1).a(one_min_bit_b).b(bit_times_a))

    def component_select_one(self, bit: int, value: int) -> int:
        b = self.witness[bit]
        v = self.witness[value]
        f_x = (1 - b + b * v) % R_MOD
        f_x = self.append_witness(f_x)
        c = (Constraint().mult(1).left(R_MOD - 1).output(R_MOD - 1)
             .constant(1).a(bit).b(value).o(f_x))
        self.append_gate(c)
        return f_x

    def component_select_zero(self, bit: int, value: int) -> int:
        return self.gate_mul(Constraint().mult(1).a(bit).b(value))

    def component_select_point(self, bit: int, a: WitnessPoint,
                               b: WitnessPoint) -> WitnessPoint:
        x = self.component_select(bit, a.x, b.x)
        y = self.component_select(bit, a.y, b.y)
        return WitnessPoint(x, y)

    def component_select_identity(self, bit: int,
                                  a: WitnessPoint) -> WitnessPoint:
        x = self.component_select_zero(bit, a.x)
        y = self.component_select_one(bit, a.y)
        return WitnessPoint(x, y)

    # -- logic gates (src/lib.rs:269-388) ----------------------------------------

    def _append_logic_component(self, a: int, b: int, num_bits: int,
                                is_xor: bool) -> int:
        num_bits = min(num_bits, 256)
        num_quads = num_bits >> 1

        a_val = self.witness[a]
        b_val = self.witness[b]
        # MSB-first bits, restricted to the low `num_bits`
        a_bits = [(a_val >> (num_bits - 1 - i)) & 1 for i in range(num_bits)]
        b_bits = [(b_val >> (num_bits - 1 - i)) & 1 for i in range(num_bits)]

        left_acc = right_acc = out_acc = 0

        constraint = (Constraint.logic_xor(Constraint()) if is_xor
                      else Constraint.logic(Constraint()))
        for i in range(num_quads):
            idx = i * 2
            left_quad = (a_bits[idx] << 1) + a_bits[idx + 1]
            right_quad = (b_bits[idx] << 1) + b_bits[idx + 1]
            out_quad = (left_quad ^ right_quad) if is_xor \
                else (left_quad & right_quad)
            prod_quad = left_quad * right_quad

            left_acc = (left_acc * 4 + left_quad) % R_MOD
            right_acc = (right_acc * 4 + right_quad) % R_MOD
            out_acc = (out_acc * 4 + out_quad) % R_MOD

            wit_a = self.append_witness(left_acc)
            wit_b = self.append_witness(right_acc)
            wit_c = self.append_witness(prod_quad)
            wit_d = self.append_witness(out_acc)

            constraint = constraint.o(wit_c)
            self.append_custom_gate(constraint)
            constraint = constraint.a(wit_a).b(wit_b).d(wit_d)

        # pad gate: | an | bn | 0 | dn | (src/lib.rs:377-387)
        pad = (Constraint().a(constraint.w_a).b(constraint.w_b)
               .d(constraint.w_d))
        self.append_custom_gate(pad)
        return constraint.w_d

    def append_logic_and(self, a: int, b: int, num_bits: int) -> int:
        return self._append_logic_component(a, b, num_bits, False)

    def append_logic_xor(self, a: int, b: int, num_bits: int) -> int:
        return self._append_logic_component(a, b, num_bits, True)

    # -- range gate (src/lib.rs:1057-1163) ----------------------------------------

    def component_range(self, witness: int, num_bits: int) -> None:
        value = self.witness[witness]
        # LSB-first bits of the full 256-bit value
        bits = [(value >> i) & 1 for i in range(256)]

        num_gates = num_bits >> 3
        if num_bits % 8 != 0:
            num_gates += 1
        num_quads = num_gates * 4
        pad = 1 + (((num_quads << 1) - num_bits) >> 1)
        used_gates = num_gates + 1

        constraints = [Constraint.range(Constraint())] * used_gates
        accumulators = []
        accumulator = 0

        for i in range(pad, num_quads + 1):
            bit_index = (num_quads - i) << 1
            q_0 = bits[bit_index]
            q_1 = bits[bit_index + 1]
            quad = q_0 + 2 * q_1
            accumulator = (4 * accumulator + quad) % R_MOD
            acc_var = self.append_witness(accumulator)
            accumulators.append(acc_var)
            idx = i // 4
            slot = i % 4
            if slot == 0:
                constraints[idx] = constraints[idx].d(acc_var)
            elif slot == 1:
                constraints[idx] = constraints[idx].o(acc_var)
            elif slot == 2:
                constraints[idx] = constraints[idx].b(acc_var)
            else:
                constraints[idx] = constraints[idx].a(acc_var)

        # last constraint zeroed (reserved for genesis quad / padding)
        constraints[-1] = Constraint()
        if accumulators:
            constraints[-1] = constraints[-1].d(accumulators[-1])
        for c in constraints:
            self.append_custom_gate(c)
        if accumulators:
            self.assert_equal(accumulators[-1], witness)

    # -- fixed-base ECC scalar multiplication (src/lib.rs:390-540) -----------------

    def component_mul_generator(self, jubjub: int, generator) -> WitnessPoint:
        bits = 256
        multiples = [generator]
        for _ in range(1, bits):
            multiples.append(jj.double(multiples[-1]))
        multiples.reverse()  # index i = 2^(255-i) * G

        scalar = self.witness[jubjub]
        wnaf_entries = jj.compute_windowed_naf(scalar, 2)
        assert len(wnaf_entries) == bits

        scalar_acc = [0]
        point_acc = [jj.IDENTITY]
        xy_alphas = []
        for i, entry in enumerate(reversed(wnaf_entries)):
            if entry == 0:
                to_add_scalar, to_add_point = 0, jj.IDENTITY
            elif entry == -1:
                to_add_scalar, to_add_point = R_MOD - 1, jj.neg(multiples[i])
            elif entry == 1:
                to_add_scalar, to_add_point = 1, multiples[i]
            else:
                raise UnsupportedWNAF2k(f"wNAF digit {entry}")
            scalar_acc.append((2 * scalar_acc[i] + to_add_scalar) % R_MOD)
            point_acc.append(jj.add(point_acc[i], to_add_point))
            xy_alphas.append(to_add_point[0] * to_add_point[1] % R_MOD)

        for i in range(bits):
            acc_x = self.append_witness(point_acc[i][0])
            acc_y = self.append_witness(point_acc[i][1])
            accumulated_bit = self.append_witness(scalar_acc[i])

            if i == 0:
                self.assert_equal_constant(acc_x, 0, None)
                self.assert_equal_constant(acc_y, 1, None)
                self.assert_equal_constant(accumulated_bit, 0, None)

            x_beta, y_beta = multiples[i]
            xy_alpha = self.append_witness(xy_alphas[i])
            xy_beta = x_beta * y_beta % R_MOD

            c = (Constraint.group_add_curve_scalar(Constraint())
                 .left(x_beta).right(y_beta).constant(xy_beta)
                 .a(acc_x).b(acc_y).o(xy_alpha).d(accumulated_bit))
            self.append_custom_gate(c)

        # final row: wires read by the last ecc gate's "next" lookups; the
        # gate itself is a plain (vacuous) arithmetic gate — reference keeps
        # this known-weak layout (FIXME at src/lib.rs:519-533); reproducing
        # it is required for circuit-shape parity.
        acc_x = self.append_witness(point_acc[bits][0])
        acc_y = self.append_witness(point_acc[bits][1])
        last_accumulated_bit = self.append_witness(scalar_acc[bits])
        c = Constraint().a(acc_x).b(acc_y).d(last_accumulated_bit)
        self.append_gate(c)

        self.assert_equal(last_accumulated_bit, jubjub)
        return WitnessPoint(acc_x, acc_y)

    # -- variable-base ECC (src/lib.rs:809-850,931-950) ------------------------------

    def component_add_point(self, a: WitnessPoint,
                            b: WitnessPoint) -> WitnessPoint:
        x_1, y_1 = a.x, a.y
        x_2, y_2 = b.x, b.y
        p1 = (self.witness[x_1], self.witness[y_1])
        p2 = (self.witness[x_2], self.witness[y_2])
        x_3v, y_3v = jj.add(p1, p2)
        x1_y2 = p1[0] * p2[1] % R_MOD

        x_1_y_2 = self.append_witness(x1_y2)
        x_3 = self.append_witness(x_3v)
        y_3 = self.append_witness(y_3v)

        c = Constraint().a(x_1).b(y_1).o(x_2).d(y_2)
        self.append_custom_gate(Constraint.group_add_curve_addtion(c))
        self.append_custom_gate(Constraint().a(x_3).b(y_3).d(x_1_y_2))
        return WitnessPoint(x_3, y_3)

    def component_mul_point(self, jubjub: int,
                            point: WitnessPoint) -> WitnessPoint:
        scalar_bits = self.component_decomposition(jubjub, 252)
        result = self.IDENTITY
        for bit in reversed(scalar_bits):
            result = self.component_add_point(result, result)
            point_to_add = self.component_select_identity(bit, point)
            result = self.component_add_point(result, point_to_add)
        return result

    # -- columnar gadget builders ------------------------------------------------
    #
    # The reference re-synthesizes the circuit on every proof
    # (src/prover.rs:76-78); at 2^16+ gates a per-gate Python builder chain
    # dominates proving latency (SURVEY.md §7 hard part #5).  These emit
    # exactly the gates the per-gate loop would (validated in
    # tests/test_fast_synth.py) with one template constraint per call.

    def append_mul_chain(self, acc: int, b: int, count: int) -> int:
        """`count` chained q_m=1 gates: acc_{i+1} = acc_i * b (the bench
        workload's gate filler).  Identical circuit to a gate_mul loop."""
        out = acc
        w = self.witness
        bv = w[b]
        for _ in range(count):
            # inlined _gate_with_output on a fresh (never-shared) record
            c = Constraint()
            c.q_m = 1
            c.q_arith = 1
            c.q_o = R_MOD - 1
            c.w_a = out
            c.w_b = b
            o_val = w[out] * bv % R_MOD        # q_o = -1 fast path
            out = self.append_witness(o_val)
            c.w_o = out
            self.append_custom_gate(c)
        return out


class FastPlonk(Plonk):
    """Witness-only synthesis mode for per-proof re-synthesis.

    The reference re-runs full synthesis on every proof (src/prover.rs:76-78)
    but the prover only consumes the witness VALUES and public inputs — the
    constraints, wire-index columns and permutation cycles are a function of
    circuit SHAPE, already fixed at compile.  This mode runs the same gadget
    code with constraint/permutation bookkeeping compiled out (~3x less
    Python per gate, measured); the engine pairs it with compile-cached wire
    index columns.  Equivalence with the full composer (witness list, public
    inputs, gate count) is pinned by tests/test_fast_synth.py."""

    def __init__(self):
        self.witness = []
        self.instance = {}
        self.gates = 0

    def m(self) -> int:
        return self.gates

    def append_witness(self, value) -> int:
        w = self.witness
        w.append(int(value) % R_MOD)
        return len(w) - 1

    def append_custom_gate(self, c: Constraint) -> None:
        if c.public_input is not None:
            self.instance[self.gates] = c.public_input
        self.gates += 1

    def append_gate(self, c: Constraint) -> None:
        # the arithmetic() tag only sets a selector; shape-only here
        self.append_custom_gate(c)

    def _gate_with_output(self, s: Constraint) -> int:
        w = self.witness
        pi = s.public_input or 0
        x = (s.q_m * w[s.w_a] % R_MOD * w[s.w_b] + s.q_l * w[s.w_a]
             + s.q_r * w[s.w_b] + s.q_d * w[s.w_d] + s.q_c + pi) % R_MOD
        if s.public_input is not None:
            self.instance[self.gates] = s.public_input
        self.gates += 1
        w.append(x)                         # q_o = -1 fast path: o = x
        return len(w) - 1

    def append_mul_chain(self, acc: int, b: int, count: int) -> int:
        w = self.witness
        bv = w[b]
        av = w[acc]
        vals = [0] * count
        for i in range(count):
            av = av * bv % R_MOD
            vals[i] = av
        w.extend(vals)
        self.gates += count
        return len(w) - 1


class Circuit:
    """User-facing circuit trait (zksnarks::circuit::Circuit as used in
    reference tests, e.g. tests/boolean.rs:43-55). Subclasses implement
    synthesize(composer) and a no-arg constructor for the default instance."""

    def synthesize(self, composer: Plonk) -> None:
        raise NotImplementedError
