"""Width-4 TurboPlonk constraint record: 11 selector columns + 4 wires +
optional public input.

Mirrors `zksnarks::Constraint` as consumed by the reference composer
(builder methods at src/lib.rs:613-623, tag constructors at
src/lib.rs:322-326,503,547,841,1095; public fields listed at
src/key.rs:108-118).  Values are canonical Fr ints; wires are witness
indices (PrivateWire).  Instances are immutable by convention; builders
return copies, matching the reference's by-value Constraint usage.

Implementation note: this is a __slots__ class with a hand-unrolled copy,
not a dataclass — `dataclasses.replace` was 75% of witness-synthesis time
at 2^16 gates (measured: 8.5s of 11.1s; ~7 copies per gate on the
gate_mul path)."""

from __future__ import annotations

from .constants import R_MOD


def _fr(v) -> int:
    return int(v) % R_MOD


_FIELDS = ("q_m", "q_l", "q_r", "q_o", "q_c", "q_d", "q_arith", "q_range",
           "q_logic", "q_fixed_group_add", "q_variable_group_add",
           "w_a", "w_b", "w_o", "w_d", "public_input")


class Constraint:
    __slots__ = _FIELDS

    def __init__(self, q_m=0, q_l=0, q_r=0, q_o=0, q_c=0, q_d=0,
                 q_arith=0, q_range=0, q_logic=0, q_fixed_group_add=0,
                 q_variable_group_add=0, w_a=0, w_b=0, w_o=0, w_d=0,
                 public_input=None):
        self.q_m = q_m
        self.q_l = q_l
        self.q_r = q_r
        self.q_o = q_o
        self.q_c = q_c
        self.q_d = q_d          # a.k.a. q_4
        self.q_arith = q_arith
        self.q_range = q_range
        self.q_logic = q_logic
        self.q_fixed_group_add = q_fixed_group_add
        self.q_variable_group_add = q_variable_group_add
        self.w_a = w_a          # default wires point at the ZERO witness
        self.w_b = w_b
        self.w_o = w_o
        self.w_d = w_d
        self.public_input = public_input

    def _copy(self) -> "Constraint":
        new = Constraint.__new__(Constraint)
        new.q_m = self.q_m
        new.q_l = self.q_l
        new.q_r = self.q_r
        new.q_o = self.q_o
        new.q_c = self.q_c
        new.q_d = self.q_d
        new.q_arith = self.q_arith
        new.q_range = self.q_range
        new.q_logic = self.q_logic
        new.q_fixed_group_add = self.q_fixed_group_add
        new.q_variable_group_add = self.q_variable_group_add
        new.w_a = self.w_a
        new.w_b = self.w_b
        new.w_o = self.w_o
        new.w_d = self.w_d
        new.public_input = self.public_input
        return new

    def __repr__(self):
        parts = ", ".join(f"{f}={getattr(self, f)!r}" for f in _FIELDS
                          if getattr(self, f) not in (0, None))
        return f"Constraint({parts})"

    def __eq__(self, other):
        if not isinstance(other, Constraint):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f) for f in _FIELDS)

    # -- selector builders (src/lib.rs:613-623 usage) -----------------------
    def mult(self, v):
        c = self._copy()
        c.q_m = _fr(v)
        return c

    def left(self, v):
        c = self._copy()
        c.q_l = _fr(v)
        return c

    def right(self, v):
        c = self._copy()
        c.q_r = _fr(v)
        return c

    def output(self, v):
        c = self._copy()
        c.q_o = _fr(v)
        return c

    def fourth(self, v):
        c = self._copy()
        c.q_d = _fr(v)
        return c

    def constant(self, v):
        c = self._copy()
        c.q_c = _fr(v)
        return c

    def public(self, v):
        c = self._copy()
        c.public_input = _fr(v)
        return c

    # -- wire builders -------------------------------------------------------
    def a(self, w):
        c = self._copy()
        c.w_a = int(w)
        return c

    def b(self, w):
        c = self._copy()
        c.w_b = int(w)
        return c

    def o(self, w):
        c = self._copy()
        c.w_o = int(w)
        return c

    def d(self, w):
        c = self._copy()
        c.w_d = int(w)
        return c

    # -- gate-family tag constructors ----------------------------------------
    @staticmethod
    def arithmetic(c: "Constraint") -> "Constraint":
        c = c._copy()
        c.q_arith = 1
        return c

    @staticmethod
    def range(c: "Constraint") -> "Constraint":
        c = c._copy()
        c.q_range = 1
        return c

    @staticmethod
    def logic(c: "Constraint") -> "Constraint":
        """AND gate tag: q_logic = 1, q_c = +1. The sign convention is pinned
        numerically by the delta_xor_and identity over all 16 quad pairs
        (tests/test_widgets.py): q_c=+1 vanishes exactly on AND rows,
        q_c=-1 exactly on XOR rows."""
        c = c._copy()
        c.q_logic = 1
        c.q_c = 1
        return c

    @staticmethod
    def logic_xor(c: "Constraint") -> "Constraint":
        """XOR gate tag: q_logic = 1, q_c = -1."""
        c = c._copy()
        c.q_logic = 1
        c.q_c = R_MOD - 1
        return c
