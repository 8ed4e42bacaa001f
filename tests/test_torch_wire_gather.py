"""K15, the wire gather (ops/kernels.py::wire_gather, csrc/wire_gather.cu):
the engine's wire columns, built from the witness table on the device, and
its public-input vector, against the host path they replace, kept here as
frozen copies; the plain route runs on the CPU."""

import os
import re

import numpy as np
import pytest
import torch

from dusk_plonk_torch.composer.composer import Error, FastPlonk
from dusk_plonk_torch.composer.constraint import Constraint
from dusk_plonk_torch.fields.constants import R_MOD
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.limb import fr_field, int_to_limbs
from dusk_plonk_torch.prelude import (
    ChaCha12Rng, Circuit, PlonkKey, PlonkParams, compile_circuit_torch)
from dusk_plonk_torch.proving import engine as engine_mod

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = fr_field()


class Chain(Circuit):
    """The bench circuit cut to n = 128: a mul chain of 70 gates, a 16-bit
    range check of x and 16-bit XOR and AND of x with the chain's end; the
    domain's last gates are padding, whose wires read the zero row."""

    def __init__(self, x=3):
        self.x = x

    def synthesize(self, c):
        w = c.append_witness(self.x)
        acc = c.append_witness(1)
        acc = c.append_mul_chain(acc, w, 70)
        c.component_range(w, 16)
        c.append_logic_xor(w, acc, 16)
        c.append_logic_and(w, acc, 16)


class Public(Circuit):
    """Two public inputs: a product and a sum asserted to constants."""

    def __init__(self, a=13, b=5):
        self.a, self.b = a, b

    def synthesize(self, c):
        w_a = c.append_witness(self.a)
        w_b = c.append_witness(self.b)
        prod = c.gate_mul(Constraint().mult(1).a(w_a).b(w_b))
        c.assert_equal_constant(prod, 0, (-self.a * self.b) % R_MOD)
        total = c.gate_add(Constraint().left(1).right(1).a(w_a).b(w_b))
        c.assert_equal_constant(total, 0, (-self.a - self.b) % R_MOD)


class NearModulus(Circuit):
    """Witnesses r - 1, r - 2, ..., r - 40 on sums, to the top of the
    field (not satisfied: wire columns only)."""

    def __init__(self, top=1):
        self.top = top

    def synthesize(self, c):
        ws = [c.append_witness(R_MOD - self.top - i) for i in range(40)]
        for a, b in zip(ws[::2], ws[1::2]):
            c.gate_add(Constraint().left(1).right(1).a(a).b(b))


# -- the host path K15 replaced (frozen) ---------------------------------------------

def host_wire_vals(plan, circuit):
    """The wire columns as the engine built them before K15: a numpy
    gather, widen and transpose on the host, then K1's multiply by R^2."""
    cs = FastPlonk.initialize()
    circuit.synthesize(cs)
    cols, nw, _ = plan
    buf = b"".join(v.to_bytes(32, "little") for v in cs.witness)
    wit = np.frombuffer(buf + bytes(32), dtype="<u2").reshape(nw + 1, 16)
    wires = np.ascontiguousarray(
        np.moveaxis(wit[cols], -1, 1).astype(np.int32))
    return F.mul(torch.from_numpy(wires), F.const("r2", "cpu"))


def host_pack_sparse(pairs, n):
    """LimbField.pack_sparse before K15: a dense host array."""
    spec = F.spec
    arr = np.zeros((n, F.L), np.int32)
    for i, v in pairs:
        arr[i] = int_to_limbs(spec, v * spec.mont_r % spec.modulus)
    return torch.from_numpy(np.ascontiguousarray(arr.T))


def _limb_ints(t):
    """(..., 16, n) limbs -> the flat list of their Python ints."""
    flat = t.movedim(-2, -1).reshape(-1, 16).numpy().astype("<u2")
    return [int.from_bytes(r.tobytes(), "little") for r in flat]


# -- tests ---------------------------------------------------------------------------

def _engine(circuit_cls, route):
    """An engine on the CPU: the host key with the wire plan made at the
    first proof ("lazy"), or the device key, which hands its plan to the
    engine ("compiled")."""
    rng = ChaCha12Rng.seed_from_u64(8349)
    if route == "lazy":
        prover, _ = compile_circuit_torch(PlonkParams.setup(8, rng),
                                          circuit_cls(), "cpu")
    else:
        prover, _ = PlonkKey.compile_device(
            PlonkParams.setup_device(8, rng, "cpu"), circuit_cls,
            device="cpu")
    return prover.engine


@pytest.mark.parametrize("circuit_cls, args, route", [
    (Chain, [(3,), (2 ** 16 - 1,)], "compiled"),
    (Chain, [(5,)], "lazy"),
    (Public, [(13, 5), (7, 11)], "compiled"),
    (NearModulus, [(1,), (41,)], "lazy"),
], ids=["bench_chain", "bench_chain_lazy", "public_inputs", "near_r"])
def test_wire_columns_match_host_path(circuit_cls, args, route):
    """K15's plain route on the engine's table gives the host path's
    (4, 16, n) Montgomery limbs, proof after proof through one pinned
    buffer; padding reads the zero row; pi_dense equals the host's
    dense array."""
    eng = _engine(circuit_cls, route)
    n = eng.n
    for a in args:
        circuit = circuit_cls(*a)
        cs = eng._synthesize_fast(circuit)
        cols, nw, m = eng._wire_plan
        got = kernels.wire_gather(F, eng._wit_table, eng._wire_cols)
        want = host_wire_vals(eng._wire_plan, circuit)
        assert got.shape == (4, 16, n) and got.dtype == torch.int32
        assert torch.equal(got, want)
        assert not eng._wit_table[nw].any()
        assert m < n and (eng._wire_cols[:, m:] == nw).all()
        assert not got[..., m:].any()
        pairs = list(zip(cs.public_input_indexes(), cs.instance_values()))
        assert len(pairs) == (2 if circuit_cls is Public else 0)
        assert torch.equal(F.pack_sparse(pairs, n, "cpu"),
                           host_pack_sparse(pairs, n))


@pytest.mark.parametrize("top", [1, 2 ** 64, R_MOD // 2])
def test_wire_gather_plain_is_value_times_r(top):
    """Each output column is the indexed row's value times R mod r, by
    Python ints, values r - top - i."""
    gen = torch.Generator().manual_seed(top % 1000)
    vals = [(R_MOD - top - i) % R_MOD for i in range(37)] + [0]
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    table = torch.from_numpy(
        np.frombuffer(buf, "<i4").reshape(len(vals), 8).copy())
    cols = torch.randint(0, len(vals), (3, 50), generator=gen,
                         dtype=torch.int32)
    out = kernels.wire_gather(F, table, cols)
    R = F.spec.mont_r
    want = [vals[j] * R % R_MOD for row in cols.tolist() for j in row]
    assert _limb_ints(out) == want


def test_wire_gather_checks_its_operands():
    table = torch.zeros((5, 8), dtype=torch.int32)
    cols = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.wire_gather(F, table, cols.long())
    with pytest.raises(ValueError):
        kernels.wire_gather(F, table[:, :4], cols)
    with pytest.raises(ValueError):
        kernels.wire_gather(F, table, cols.t())


def test_r2_words_in_source():
    """csrc/wire_gather.cu's immediate R^2 is the field's R^2 mod r."""
    src = open(os.path.join(ROOT, "dusk_plonk_torch", "csrc",
                            "wire_gather.cu")).read()
    body = re.search(r"#define FR_R2_WORDS\s*\\?\s*\{([^}]*)\}", src)[1]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", body)]
    assert len(words) == 8
    assert sum(w << (32 * i) for i, w in enumerate(words)) == \
        F.spec.mont_r2


class Growing(Circuit):
    def __init__(self, extra=0):
        self.extra = extra

    def synthesize(self, c):
        w = c.append_witness(3)
        for _ in range(self.extra):
            w = c.gate_add(Constraint().left(1).a(w))
        c.component_boolean(c.append_witness(1))


def test_shape_change_raises():
    """A circuit whose witness count or gate count moved since compile
    still raises the composer's Error, word for word."""
    rng = ChaCha12Rng.seed_from_u64(8349)
    prover, _ = compile_circuit_torch(PlonkParams.setup(5, rng), Growing(),
                                      "cpu")
    eng = prover.engine
    eng._synthesize_fast(Growing())
    _, nw, m = eng._wire_plan
    grown = FastPlonk.initialize()
    Growing(1).synthesize(grown)
    assert (len(grown.witness), grown.m()) == (nw + 1, m + 1)
    with pytest.raises(Error, match=re.escape(
            f"circuit shape changed between compile and prove: "
            f"{nw + 1} witnesses / {m + 1} gates vs compiled {nw} / {m}")):
        eng._synthesize_fast(Growing(1))


def test_one_gather_a_proof(monkeypatch):
    """A proof calls the wire gather once, before round 1, and no K1
    multiply runs between the start and the wire_pack mark (the host path
    made one there); the proof verifies."""
    calls = []
    for name in ("mont_mul", "wire_gather"):
        real = getattr(kernels, name)

        def spy(*a, real=real, name=name):
            calls.append(name)
            return real(*a)
        monkeypatch.setattr(kernels, name, spy)

    class Marked(engine_mod.Marks):
        def __call__(self, label):
            calls.append(label)
            super().__call__(label)
    monkeypatch.setattr(engine_mod, "Marks", Marked)

    rng = ChaCha12Rng.seed_from_u64(8349)
    prover, verifier = compile_circuit_torch(PlonkParams.setup(7, rng),
                                             Public(), "cpu")
    del calls[:]
    proof, pis = prover.create_proof(rng, Public(13, 5))
    verifier.verify(proof, pis)
    assert calls[:3] == ["synthesize", "wire_gather", "wire_pack"]
    assert calls.count("wire_gather") == 1
