"""Key compilation: circuit -> (Prover, Verifier).

Behavioral port of reference src/key.rs (PlonkKey::compile_with_circuit):
pad to n = next_pow2(m), trim SRS, iFFT 11 selector columns, build 4 sigma
polynomials, commit 15 polynomials, precompute all 8n-coset evaluation
tables and the coset vanishing polynomial.

The host version (compile_circuit) is the oracle; compile_circuit_torch
attaches the torch engine to its keys, and compile_circuit_device runs the
NTTs and commitments on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.constants import R_MOD
from ..fields.host import fr_batch_inv
from ..poly.domain import Domain
from ..composer.composer import Plonk
from ..transcript.plonk_transcript import PlonkTranscript

SELECTOR_NAMES = ("q_m", "q_l", "q_r", "q_o", "q_c", "q_4", "q_arith",
                  "q_range", "q_logic", "q_fixed_group_add",
                  "q_variable_group_add")
SIGMA_NAMES = ("s_sigma_1", "s_sigma_2", "s_sigma_3", "s_sigma_4")


def next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


@dataclass
class VerificationKey:
    """Reference VerificationKey fields at src/key.rs:203-214 (n stores the
    raw constraint count m; callers pad: src/prover/proof.rs:180)."""
    n: int
    n_inv: int
    generator: int
    generator_inv: int
    commitments: dict  # name -> G1 affine

    def to_bytes(self) -> bytes:
        """SCALE layout: n (u64 LE) ++ n_inv/generator/generator_inv
        (32B Montgomery Fr) ++ 15 G1Affine(97B) in selector+sigma order."""
        from .proof import _fr_scale, _g1_scale
        out = [self.n.to_bytes(8, "little"),
               _fr_scale(self.n_inv), _fr_scale(self.generator),
               _fr_scale(self.generator_inv)]
        out.extend(_g1_scale(self.commitments[name])
                   for name in SELECTOR_NAMES + SIGMA_NAMES)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "VerificationKey":
        from .proof import _fr_unscale, _g1_unscale
        if len(data) != 8 + 3 * 32 + 15 * 97:
            raise ValueError(f"bad VerificationKey length {len(data)}")
        n = int.from_bytes(data[0:8], "little")
        n_inv = _fr_unscale(data[8:40])
        generator = _fr_unscale(data[40:72])
        generator_inv = _fr_unscale(data[72:104])
        commitments = {}
        off = 104
        for name in SELECTOR_NAMES + SIGMA_NAMES:
            commitments[name] = _g1_unscale(data[off:off + 97])
            off += 97
        return cls(n=n, n_inv=n_inv, generator=generator,
                   generator_inv=generator_inv, commitments=commitments)


@dataclass
class ProvingKey:
    """Reference ProvingKey at src/key.rs:293-302: per-family
    (coefficients, 8n-coset evaluations) pairs plus the linear polynomial's
    coset evaluations and v_h_coset_8n (we also precompute its inverse —
    the reference inverts per-element in the quotient loop,
    src/prover/quotient_poly.rs:111; batch inversion is strictly better)."""
    n: int
    domain: Domain
    domain_8n: Domain
    selector_polys: dict          # name -> coeff list (len n)
    sigma_polys: list             # 4 coeff lists
    selector_evals_8n: dict       # name -> eval list (len 8n)
    sigma_evals_8n: list          # 4 eval lists
    linear_evals_8n: list         # coset evals of X
    v_h_coset_8n: list
    v_h_coset_8n_inv: list


def compile_circuit(params, circuit, label: bytes = b"plonk"):
    """PlonkKey::compile_with_circuit (reference src/key.rs:63-327)."""
    from .prover import Prover
    from .verifier import Verifier

    cs = Plonk.initialize()
    circuit.synthesize(cs)

    m = cs.m()
    n = next_pow2(m)
    k = n.bit_length() - 1
    additional_n = next_pow2(m + 6)
    trimmed = params.trim(additional_n)
    domain = Domain(k)

    # selector columns, zero-padded to n
    columns = {name: [0] * n for name in SELECTOR_NAMES}
    for i, c in enumerate(cs.constraints):
        columns["q_m"][i] = c.q_m
        columns["q_l"][i] = c.q_l
        columns["q_r"][i] = c.q_r
        columns["q_o"][i] = c.q_o
        columns["q_c"][i] = c.q_c
        columns["q_4"][i] = c.q_d
        columns["q_arith"][i] = c.q_arith
        columns["q_range"][i] = c.q_range
        columns["q_logic"][i] = c.q_logic
        columns["q_fixed_group_add"][i] = c.q_fixed_group_add
        columns["q_variable_group_add"][i] = c.q_variable_group_add

    selector_polys = {name: domain.idft(col) for name, col in columns.items()}
    sigma_polys = cs.perm.compute_sigma_polynomials(n, domain)

    commitments = {}
    for name in SELECTOR_NAMES:
        commitments[name] = trimmed.commit(selector_polys[name])
    for name, poly in zip(SIGMA_NAMES, sigma_polys):
        commitments[name] = trimmed.commit(poly)

    verifier_key = VerificationKey(
        n=m,
        n_inv=domain.size_inv,
        generator=domain.generator,
        generator_inv=domain.generator_inv,
        commitments=commitments,
    )

    # 8n coset tables ("blinding makes 4n insufficient", src/key.rs:216-222)
    x8n = next_pow2(8 * n)
    domain_8n = Domain(x8n.bit_length() - 1)
    selector_evals_8n = {name: domain_8n.coset_dft(poly)
                         for name, poly in selector_polys.items()}
    sigma_evals_8n = [domain_8n.coset_dft(p) for p in sigma_polys]
    linear_evals_8n = domain_8n.coset_dft([0, 1])
    v_h = domain_8n.compute_vanishing_poly_over_coset(n)
    v_h_inv = fr_batch_inv(v_h)

    prover_key = ProvingKey(
        n=n,
        domain=domain,
        domain_8n=domain_8n,
        selector_polys=selector_polys,
        sigma_polys=sigma_polys,
        selector_evals_8n=selector_evals_8n,
        sigma_evals_8n=sigma_evals_8n,
        linear_evals_8n=linear_evals_8n,
        v_h_coset_8n=v_h,
        v_h_coset_8n_inv=v_h_inv,
    )

    prover = Prover(label, trimmed, prover_key, verifier_key, n, m)
    verifier = Verifier(label, verifier_key, trimmed.verification_key(),
                        cs.public_input_indexes(), n, m)
    return prover, verifier


def compile_circuit_torch(params, circuit, device="cuda",
                          label: bytes = b"plonk"):
    """Host key compilation (compile_circuit) with a TorchEngine on
    `device` attached to the prover: afterwards
    `prover.create_proof(rng, circuit)` runs the port.  Returns
    (prover, verifier)."""
    from .engine import TorchEngine

    prover, verifier = compile_circuit(params, circuit, label)
    prover.use_device_engine(TorchEngine(prover, device))
    return prover, verifier


def compile_circuit_device(params, circuit, device="cuda",
                           label: bytes = b"plonk"):
    """Key compilation on the device (reference src/key.rs:63-327): the 11
    selector and 4 sigma iNTTs (kernels K2, K1) and the 15 commitments in
    one MSM batch run on `device`; the host synthesizes the circuit and
    builds the sigma permutation.  The verification key equals
    compile_circuit's.  Returns (prover with a TorchEngine attached,
    verifier); the ProvingKey carries no host tables, so the prover's host
    oracle path is unavailable.  `prover.engine.compile_timings` holds the
    per-step wall times, `prover.engine.compile_peaks` the device's peak
    bytes allocated in each step (CUDA only; "commit15" is the 15-commit
    batch)."""
    import torch

    from .engine import TorchEngine
    from .prover import Prover
    from .verifier import Verifier
    from ..convert import as_limbs
    from ..fields.constants import PERM_K1, PERM_K2, PERM_K3
    from ..fields.host import fr_root_of_unity
    from ..ops.ec import device_g1
    from ..ops.limb import fr_field
    from ..ops.msm import MsmPlan
    from ..ops.ntt import NttPlan
    from ..utils.timing import Marks

    marks = Marks(device)
    cs = Plonk.initialize()
    circuit.synthesize(cs)
    m = cs.m()
    n = next_pow2(m)
    k = n.bit_length() - 1
    trimmed = params.trim(next_pow2(m + 6))
    domain = Domain(k)
    domain_8n = Domain(next_pow2(8 * n).bit_length() - 1)
    F = fr_field()
    marks("synthesize")

    # selector columns (11, n) and the sigma permutation's Lagrange values
    # ks[col] * w^gate, both in Montgomery form on the device
    flat = []
    for name in SELECTOR_NAMES:
        attr = {"q_4": "q_d"}.get(name, name)
        col = [getattr(c, attr) for c in cs.constraints]
        flat.extend(col + [0] * (n - len(col)))
    cols = F.pack(flat, device, shape=(11, n))
    marks("pack_columns")
    sigmas = cs.perm.compute_sigma_permutations(n)
    col_idx = torch.tensor([[c for c, _ in s] for s in sigmas],
                           device=device)                        # (4, n)
    gate_idx = torch.tensor([[g for _, g in s] for s in sigmas],
                            device=device)
    marks("sigma_permutation")
    ks = F.pack([1, PERM_K1, PERM_K2, PERM_K3], device)          # (16, 4)
    roots = F.powers_host_base(fr_root_of_unity(k), n, device)   # (16, n)
    sig_lagrange = F.mul(ks[:, col_idx].movedim(0, 1),
                         roots[:, gate_idx].movedim(0, 1))      # (4, 16, n)
    plan = NttPlan(k, device)
    sel_polys = plan.idft(cols)                                  # (11, 16, n)
    sigma_polys = plan.idft(sig_lagrange)                        # (4, 16, n)
    ns = trimmed.n_powers()
    canon = torch.zeros((15, F.L, ns), dtype=torch.int32, device=device)
    canon[..., :n] = F.from_mont(torch.cat([sel_polys, sigma_polys]))
    marks("polys")

    if trimmed.packed is not None:
        srs = tuple(as_limbs(c, device) for c in trimmed.packed)
    else:
        srs = device_g1().pack_points(trimmed.powers, device)
    msm = MsmPlan(ns)
    srs_em = msm.prepare_points(srs)
    marks("pack_srs")
    commitments = dict(zip(SELECTOR_NAMES + SIGMA_NAMES,
                           msm.msm_affine_batch(srs_em, canon)))
    marks("commit15")

    verifier_key = VerificationKey(
        n=m, n_inv=domain.size_inv, generator=domain.generator,
        generator_inv=domain.generator_inv, commitments=commitments)
    prover_key = ProvingKey(
        n=n, domain=domain, domain_8n=domain_8n,
        selector_polys=None, sigma_polys=None, selector_evals_8n=None,
        sigma_evals_8n=None, linear_evals_8n=None, v_h_coset_8n=None,
        v_h_coset_8n_inv=None)
    prover = Prover(label, trimmed, prover_key, verifier_key, n, m)
    engine = TorchEngine(
        prover, device, sel_polys=sel_polys, sigma_polys=sigma_polys,
        srs=srs, msm=msm, srs_em=srs_em,
        wire_plan=TorchEngine.build_wire_plan(cs, n))
    prover.use_device_engine(engine)
    verifier = Verifier(label, verifier_key, trimmed.verification_key(),
                        cs.public_input_indexes(), n, m)
    marks("engine")
    engine.compile_timings = marks.times
    engine.compile_peaks = marks.peaks
    return prover, verifier
