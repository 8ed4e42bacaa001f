"""The Plonk composer: witness allocation, gate appending and the
gadgets that the benchmark's circuits use (the multiplication chain, the
range check and the logic gates).

Behavioral re-implementation of reference src/lib.rs (struct Plonk + gadget
methods). Witness values are canonical Fr ints; wires are integer indices.
Gate layouts (which wires/selectors each gadget emits, and in which order)
are part of circuit identity and follow the reference exactly; the gate
*formulas* they satisfy live in widgets.py.  A circuit that needs another
gadget (the ECC gadgets, select, decomposition, public inputs) brings its
frozen copy here with it.
"""

from __future__ import annotations

from .constants import R_MOD
from .constraint import Constraint
from .permutation import Permutation


class Plonk:
    """Constraint system (reference `Plonk<C>` at src/lib.rs:102-115)."""

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

    def m(self) -> int:
        return len(self.constraints)

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

    def append_gate(self, c: Constraint) -> None:
        """Arithmetic gate: q_m·a·b + q_l·a + q_r·b + q_o·o + q_4·d + q_c
        + PI = 0 (src/lib.rs:542-550)."""
        self.append_custom_gate(Constraint.arithmetic(c))

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
