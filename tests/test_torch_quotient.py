"""Kernel K14's plain version (dusk_plonk_torch.ops.kernels.quotient on CPU
tensors) on seeded random field elements in every input, so that every gate
family contributes: limb for limb against the same widget chain run through
the JAX package's widgets and LimbField on jnp arrays (fewer than 512
lanes: XLA's multiply, no Pallas kernel), against host ints, in its halo
form against the rolled form on one device and on two shards, and its
constant table against the products the chain formed on tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusk_plonk_tpu.ops.limb import fr_field as jax_fr
from dusk_plonk_tpu.proving import widgets as jax_widgets
from dusk_plonk_tpu.proving.engine import DeviceOps
from dusk_plonk_torch.fields.constants import R_MOD
from dusk_plonk_torch.ops import kernels
from dusk_plonk_torch.ops.limb import fr_field, int_to_limbs
from dusk_plonk_torch.parallel import mesh as M
from dusk_plonk_torch.proving import widgets
from dusk_plonk_torch.proving.keys import SELECTOR_NAMES

torch.set_num_threads(1)

CHALLENGES = ("alpha", "beta", "gamma", "range_sep", "logic_sep",
              "fixed_base_sep", "var_base_sep")


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(n)]


def make_inputs(E, seed):
    """Canonical values and their Montgomery limbs for one grid of E
    points: {name: (ints, (rows, 16, E) or (16, E) tensor)}, and the
    challenges' ints."""
    F = fr_field()
    rng = np.random.default_rng(seed)
    rows = {"evs": 6, "sel8": 11, "sig8": 4, "l1_8": 0, "lin8": 0,
            "vh_inv8": 0}
    out = {}
    for name, r in rows.items():
        vals = _ints(rng, max(r, 1) * E)
        vals[:3] = [0, 1, R_MOD - 1]             # carry edges on lane 0-2
        t = F.pack(vals, "cpu", shape=(r, E) if r else None)
        out[name] = (vals, t)
    ch = dict(zip(CHALLENGES, _ints(rng, len(CHALLENGES))))
    return out, ch


def _args(inputs, ch, halo):
    t = {k: v[1] for k, v in inputs.items()}
    return (t["evs"], halo, t["sel8"], t["sig8"], t["l1_8"], t["lin8"],
            t["vh_inv8"], kernels.quotient_consts(fr_field(), ch, "cpu"))


def _own_halo(evs):
    return evs[[0, 1, 2, 4], :, :8].contiguous()


def rolled_chain(F, evs, sel8, sig8, l1_8, lin8, vh_inv8, ch):
    """The engine's quotient before K14: the widget chain over LimbField
    with the challenges packed one by one and the next gate as
    torch.roll(x, -8) copies."""
    class Ops:
        add, sub, mul = F.add, F.sub, F.mul

        @staticmethod
        def scalar(v):
            return F.pack_scalar(v % R_MOD, "cpu")

    chp = {k: F.pack_scalar(v, "cpu") for k, v in ch.items()}
    z8, a8, b8, c8, d8, pi8 = evs
    z_n, a_n, b_n, d_n = (torch.roll(evs[i], -8, dims=-1)
                          for i in (0, 1, 2, 4))
    s = dict(zip(SELECTOR_NAMES, sel8))
    t = widgets.arithmetic_quotient(
        Ops, s["q_m"], s["q_l"], s["q_r"], s["q_o"], s["q_c"], s["q_4"],
        s["q_arith"], a8, b8, c8, d8)
    t = F.add(t, pi8)
    t = F.add(t, widgets.range_quotient(
        Ops, s["q_range"], chp["range_sep"], a8, b8, c8, d8, d_n))
    t = F.add(t, widgets.logic_quotient(
        Ops, s["q_logic"], s["q_c"], chp["logic_sep"],
        a8, a_n, b8, b_n, c8, d8, d_n))
    t = F.add(t, widgets.fixed_base_quotient(
        Ops, s["q_fixed_group_add"], s["q_l"], s["q_r"], s["q_c"],
        chp["fixed_base_sep"], a8, a_n, b8, b_n, c8, d8, d_n))
    t = F.add(t, widgets.variable_base_quotient(
        Ops, s["q_variable_group_add"], chp["var_base_sep"],
        a8, a_n, b8, b_n, c8, d8, d_n))
    l1_alpha_sq = F.mul(l1_8, F.mul(chp["alpha"], chp["alpha"]))
    t = F.add(t, widgets.permutation_quotient(
        Ops, lin8, sig8[0], sig8[1], sig8[2], sig8[3], a8, b8, c8, d8,
        z8, z_n, chp["alpha"], l1_alpha_sq, chp["beta"], chp["gamma"]))
    return F.mul(t, vh_inv8)


class _JittedOps(DeviceOps):
    """The JAX engine's widgets backend with each field operation jitted
    on its own, as round3b runs them under jit: one compile a shape, not
    one dispatch a primitive."""

    def __init__(self, F):
        super().__init__(F)
        self.add, self.sub, self.mul = (jax.jit(F.add), jax.jit(F.sub),
                                        F._jit_mul)


@pytest.fixture(scope="module")
def grid64():
    inputs, ch = make_inputs(64, seed=14)
    evs = inputs["evs"][1]
    out = kernels.quotient(fr_field(), *_args(inputs, ch, _own_halo(evs)))
    return inputs, ch, out


def test_quotient_equals_the_jax_widget_chain(grid64):
    """(a) The JAX package's widgets on its LimbField (round3b's chain,
    the next gate by jnp.roll), on the same limbs."""
    inputs, ch, out = grid64
    jF = jax_fr()
    ops = _JittedOps(jF)
    j = {k: jnp.asarray(v[1].numpy().astype(np.uint32))
         for k, v in inputs.items()}
    chj = {k: jF.pack_scalar(v) for k, v in ch.items()}
    z8, a8, b8, c8, d8, pi8 = j["evs"]
    z_n, a_n, b_n, d_n = (jnp.roll(j["evs"][i], -8, axis=-1)
                          for i in (0, 1, 2, 4))
    s = {name: j["sel8"][i] for i, name in enumerate(SELECTOR_NAMES)}
    sg = j["sig8"]
    t = jax_widgets.arithmetic_quotient(
        ops, s["q_m"], s["q_l"], s["q_r"], s["q_o"], s["q_c"], s["q_4"],
        s["q_arith"], a8, b8, c8, d8)
    t = ops.add(t, pi8)
    t = ops.add(t, jax_widgets.range_quotient(
        ops, s["q_range"], chj["range_sep"], a8, b8, c8, d8, d_n))
    t = ops.add(t, jax_widgets.logic_quotient(
        ops, s["q_logic"], s["q_c"], chj["logic_sep"],
        a8, a_n, b8, b_n, c8, d8, d_n))
    t = ops.add(t, jax_widgets.fixed_base_quotient(
        ops, s["q_fixed_group_add"], s["q_l"], s["q_r"], s["q_c"],
        chj["fixed_base_sep"], a8, a_n, b8, b_n, c8, d8, d_n))
    t = ops.add(t, jax_widgets.variable_base_quotient(
        ops, s["q_variable_group_add"], chj["var_base_sep"],
        a8, a_n, b8, b_n, c8, d8, d_n))
    l1_alpha_sq = ops.mul(j["l1_8"], ops.mul(chj["alpha"], chj["alpha"]))
    t = ops.add(t, jax_widgets.permutation_quotient(
        ops, j["lin8"], sg[0], sg[1], sg[2], sg[3], a8, b8, c8, d8, z8, z_n,
        chj["alpha"], l1_alpha_sq, chj["beta"], chj["gamma"]))
    t = ops.mul(t, j["vh_inv8"])
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(t).astype(np.int32))


def test_quotient_equals_host_ints(grid64):
    """(b) The widget chain on widgets.HostOps, point by point."""
    inputs, ch, out = grid64
    E = 64
    v = {k: vals for k, (vals, _) in inputs.items()}

    def row(name, r, i):
        return v[name][r * E + i % E]

    ops = widgets.HostOps
    got = fr_field().unpack(out)
    for i in range(E):
        z, a, b, c, d, pi = (row("evs", r, i) for r in range(6))
        z_n, a_n, b_n, d_n = (row("evs", r, i + 8) for r in (0, 1, 2, 4))
        s = {name: row("sel8", r, i) for r, name in enumerate(SELECTOR_NAMES)}
        sg = [row("sig8", r, i) for r in range(4)]
        t = widgets.arithmetic_quotient(
            ops, s["q_m"], s["q_l"], s["q_r"], s["q_o"], s["q_c"], s["q_4"],
            s["q_arith"], a, b, c, d)
        t += pi
        t += widgets.range_quotient(ops, s["q_range"], ch["range_sep"],
                                    a, b, c, d, d_n)
        t += widgets.logic_quotient(ops, s["q_logic"], s["q_c"],
                                    ch["logic_sep"], a, a_n, b, b_n, c, d,
                                    d_n)
        t += widgets.fixed_base_quotient(
            ops, s["q_fixed_group_add"], s["q_l"], s["q_r"], s["q_c"],
            ch["fixed_base_sep"], a, a_n, b, b_n, c, d, d_n)
        t += widgets.variable_base_quotient(
            ops, s["q_variable_group_add"], ch["var_base_sep"],
            a, a_n, b, b_n, c, d, d_n)
        l1a2 = row("l1_8", 0, i) * ch["alpha"] ** 2
        t += widgets.permutation_quotient(
            ops, row("lin8", 0, i), *sg, a, b, c, d, z, z_n, ch["alpha"],
            l1a2 % R_MOD, ch["beta"], ch["gamma"])
        assert got[i] == t * row("vh_inv8", 0, i) % R_MOD, i


def test_quotient_halo_form_equals_rolled_form(grid64):
    """(c) One device, E = 64: the halo is the coset's own first 8
    points; two shards of 32: each shard's halo from M.next_halo, the
    shards' grids concatenated."""
    inputs, ch, out = grid64
    F = fr_field()
    t = {k: x for k, (_, x) in inputs.items()}
    want = rolled_chain(F, t["evs"], t["sel8"], t["sig8"], t["l1_8"],
                        t["lin8"], t["vh_inv8"], ch)
    assert torch.equal(out, want)

    mesh = M.Mesh(["cpu"] * 2)
    sh = {k: M.shard(mesh, x) for k, x in t.items()}
    halos = M.next_halo(mesh, [e[[0, 1, 2, 4], :, :8].contiguous()
                               for e in sh["evs"]], 8)
    consts = kernels.quotient_consts(F, ch, "cpu")
    parts = [kernels.quotient(F, sh["evs"][j], halos[j].contiguous(),
                              sh["sel8"][j], sh["sig8"][j], sh["l1_8"][j],
                              sh["lin8"][j], sh["vh_inv8"][j], consts)
             for j in range(2)]
    assert all(p.shape == (16, 32) for p in parts)
    assert torch.equal(torch.cat(parts, dim=-1), want)


def test_quotient_table_equals_the_chains_products():
    """(d) quotient_consts from the challenges' ints: each challenge as
    pack_scalar gives it, alpha^2 and the separators' kappa powers as the
    chain formed them with F.mul on packed scalars, and each constant as
    the engine's TorchOps packed it."""
    F = fr_field()
    ch = dict(zip(CHALLENGES, _ints(np.random.default_rng(5), 7)))
    table = kernels.quotient_consts(F, ch, "cpu")
    assert table.shape == (16, len(kernels.QUOTIENT_TABLE))
    col = {k: table[:, j:j + 1] for j, k in enumerate(kernels.QUOTIENT_TABLE)}
    chp = {k: F.pack_scalar(v, "cpu") for k, v in ch.items()}
    want = dict(chp, alpha_sq=F.mul(chp["alpha"], chp["alpha"]))
    for fam, sep, top in (("range", "range_sep", 3), ("logic", "logic_sep", 4),
                          ("fixed", "fixed_base_sep", 3),
                          ("var", "var_base_sep", 2)):
        kappa = F.mul(chp[sep], chp[sep])
        powers = [kappa]
        for _ in range(top - 1):
            powers.append(F.mul(powers[-1], kappa))
        for name, p in zip(("kappa", "kappa_sq", "kappa_cu", "kappa_qu"),
                           powers):
            want[f"{fam}_{name}"] = p
    spec = F.spec
    for key in kernels.QUOTIENT_TABLE:
        if isinstance(key, int):
            want[key] = torch.from_numpy(int_to_limbs(
                spec, key * spec.mont_r % spec.modulus)[:, None].copy())
        assert torch.equal(col[key], want[key]), key


def test_quotient_checks_its_arguments(grid64):
    """The wrapper refuses what the kernel does not take, on either
    route, and counts no launch on the CPU."""
    inputs, ch, _ = grid64
    args = list(_args(inputs, ch, _own_halo(inputs["evs"][1])))
    F = fr_field()
    kernels.reset_launches()
    bad = [(1, args[1][:, :, :4]),                      # a halo of 4
           (0, args[0][:, :, ::2]),                     # a strided view
           (7, args[7][:, :-1]),                        # a short table
           (2, args[2][:10])]                           # 10 selectors
    for pos, x in bad:
        with pytest.raises(ValueError):
            kernels.quotient(F, *args[:pos], x, *args[pos + 1:])
    with pytest.raises(TypeError):
        kernels.quotient(F, args[0].long(), *args[1:])
    kernels.quotient(F, *args)
    assert kernels.quotient.launches == 0
