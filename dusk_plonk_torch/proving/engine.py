"""The device proving engine on torch: the 5-round prover over the port's
kernels.

Counterpart of dusk_plonk_tpu/proving/engine.py::DeviceEngine.  It keeps the
same rounds, transcript labels and RNG draw order as the host oracle
(proving/prover.py::Prover._create_proof_host), so its proofs are
byte-identical to the host's.  What runs where:

* device: the wire columns (one launch of kernel K15, ops/kernels.py::
  wire_gather, from the witness table sent once a proof), every NTT
  (ops/ntt.py), the 8n quotient grid (one launch of kernel K14,
  ops/kernels.py::quotient, the widget formulas of proving/widgets.py
  fused), the grand product, batch inversion, evaluations, the KZG
  synthetic division, and every MSM (ops/msm.py);
* host: witness synthesis, transcript and challenges, blinder draws, the
  16 linearization scalars, and the window combine of each commitment
  (C++).

Round 3 runs unchunked (E = n8): the coset transforms, then the quotient
grid in one K14 launch, the counterpart of the XLA fusion of the JAX
engine's round3b.  The JAX engine's u16 storage, HBM-lean `_big`
schedules, quotient chunking and one-dispatch round-3 pipeline answer a
16 GB TPU and a tunnelled dispatch; they are not here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..composer.composer import Plonk, FastPlonk, Error
from ..convert import as_limbs
from ..fields.constants import (
    R_MOD, FR_GENERATOR, PERM_K1, PERM_K2, PERM_K3)
from ..fields.host import fr_root_of_unity
from ..rng.chacha import fr_random
from ..ops import kernels
from ..ops.ec import device_g1
from ..ops.limb import fr_field, int_to_limbs
from ..ops.msm import MsmPlan
from ..ops.ntt import NttPlan
from ..utils.timing import Marks
from ..utils.tracing import tracer
from . import widgets
from .keys import SELECTOR_NAMES
from .proof import Proof
from .prover import EVAL_TRANSCRIPT_ORDER, compute_first_lagrange_eval


# linearization_scalars emits exactly this key order (widgets.py)
LIN_ORDER = ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c", "q_range", "q_logic",
             "q_fixed_group_add", "q_variable_group_add", "z_poly",
             "s_sigma_4")


class TorchEngine:
    """Per-circuit prover state on one device; attach with
    `prover.use_device_engine(TorchEngine(prover, device))`.

    sel_polys (11, 16, n), sigma_polys (4, 16, n) and srs ((24, ns),)*3
    may be given as the JAX package's packed numpy arrays (or tensors), so
    that both engines prove from one key and SRS; by default they are
    packed from the prover's host key.  Device key compilation
    (proving/keys.py::compile_circuit_device) passes its own tensors, its
    MsmPlan and prepared SRS table (msm, srs_em) and the circuit's wire
    plan (build_wire_plan).

    The hooks below are the seams where ShardedEngine
    (proving/sharded_engine.py) swaps in the distributed pieces; on one
    device each is the plain call or a no-op, as in the JAX engine."""

    def __init__(self, prover, device, sel_polys=None, sigma_polys=None,
                 srs=None, msm=None, srs_em=None, wire_plan=None):
        pk = prover.prover_key
        self.prover = prover
        self.pk = pk
        self.device = device = torch.device(device)
        self.n = n = prover.size
        self.k = n.bit_length() - 1
        self.n8 = pk.domain_8n.size
        self.k8 = self.n8.bit_length() - 1
        self.F = F = fr_field()
        self.G1 = device_g1()
        self.plan_n = NttPlan(self.k, device)
        self.plan_8n = NttPlan(self.k8, device)
        self.last_timings: dict = {}     # per round: wall s
        self.last_peaks: dict = {}       # and peak bytes (CUDA only)

        # --- SRS ---------------------------------------------------------------
        if srs is None:
            srs = self.G1.pack_points(prover.keypair.powers, device)
        else:
            srs = tuple(as_limbs(c, device) for c in srs)
        self.srs = srs
        self.ns = srs[0].shape[-1]
        # nsd >= ns is the width of every SRS-length buffer: a mesh rounds
        # it up to a multiple of its shards (zero coefficients change no
        # commitment or evaluation)
        self.nsd = self._device_width(self.ns)
        self.msm, self.srs_em = self._make_msm(msm, srs_em)

        # --- key polynomials (n-degree coefficient form) --------------------
        if sel_polys is None:
            flat = [v for name in SELECTOR_NAMES for v in pk.selector_polys[name]]
            sel_polys = F.pack(flat, device, shape=(11, n))
        if sigma_polys is None:
            flat = [v for p in pk.sigma_polys for v in p]
            sigma_polys = F.pack(flat, device, shape=(4, n))
        self.sel_polys = as_limbs(sel_polys, device)
        self.sigma_polys = as_limbs(sigma_polys, device)

        # wire-index columns are circuit SHAPE, fixed at compile: per-proof
        # synthesis runs witness-only, sends the witness table once, and
        # K15 gathers the wire columns from it on the device
        self._wire_plan = wire_plan
        self._build_tables()
        self._stage_tables()
        if wire_plan is not None:
            self._stage_wire_plan()

    # -- fast witness synthesis -----------------------------------------------

    @staticmethod
    def build_wire_plan(cs, n: int):
        """(cols, n_witness, n_gates): cols (4, n) indexes into the witness
        list, with the zero-pad tail pointing at a sentinel zero row."""
        nw = len(cs.witness)
        cols = np.full((4, n), nw, np.int64)
        for j, col in enumerate(cs.wire_cols):
            cols[j, :len(col)] = col
        return cols, nw, cs.m()

    def _stage_wire_plan(self):
        """The wire plan's cols (4, n) on the device as int32, and the
        witness table's two (nw + 1, 8) int32 buffers: a pinned host buffer
        that synthesis fills and the device table it is sent to, row nw
        the zero row.  Made once, after the engine's tables, so that they
        add nothing to the build's peak."""
        cols, nw, _ = self._wire_plan
        cols = np.asarray(cols)
        if cols.shape != (4, self.n) or cols.min() < 0 or cols.max() > nw:
            raise ValueError(f"wire plan: cols {cols.shape} must be (4, "
                             f"{self.n}) rows of 0..{nw}")
        dev = self.device
        self._wire_cols = torch.from_numpy(cols.astype(np.int32)).to(dev)
        self._wit_host = torch.zeros((nw + 1, 8), dtype=torch.int32,
                                     pin_memory=dev.type == "cuda")
        self._wit_table = torch.empty((nw + 1, 8), dtype=torch.int32,
                                      device=dev)

    def _synthesize_fast(self, circuit):
        """Witness-only synthesis -> cs, with the witness sent to the
        device table (self._wit_table: 32 bytes a witness, canonical)."""
        cs = FastPlonk.initialize()
        circuit.synthesize(cs)
        if self._wire_plan is None:
            full = Plonk.initialize()
            circuit.synthesize(full)
            self._wire_plan = self.build_wire_plan(full, self.n)
            self._stage_wire_plan()
        cols, nw, m = self._wire_plan
        if len(cs.witness) != nw or cs.m() != m:
            raise Error(
                f"circuit shape changed between compile and prove: "
                f"{len(cs.witness)} witnesses / {cs.m()} gates vs "
                f"compiled {nw} / {m}")
        buf = b"".join(v.to_bytes(32, "little") for v in cs.witness)
        # the pinned buffer is free to refill: the marks that follow this
        # copy synchronise the device before the next proof's synthesis
        self._wit_host.numpy()[:nw] = np.frombuffer(buf, "<i4").reshape(
            nw, 8)
        self._wit_table.copy_(self._wit_host, non_blocking=True)
        return cs

    # -- hooks (the seams of the sharded engine) ------------------------------

    def _t_n(self, x, kind):
        """n-domain transform of (..., 16, n); kind in {dft, idft}."""
        return getattr(self.plan_n, kind)(x)

    def _t_8n(self, x, kind):
        """8n coset transform of (..., 16, n8); kind in {coset_dft,
        coset_idft}."""
        return getattr(self.plan_8n, kind)(x)

    def _prefix_mul(self, x):
        return self.F.prefix_mul(x)

    def _batch_inv(self, x):
        return self.F.batch_inv(x)

    def _stage_dom(self, x):
        """Place a per-proof (..., 16, n) input (no-op on one device)."""
        return x

    def _make_msm(self, msm, srs_em):
        """(MSM plan, its prepared SRS table) for _commit_batch, built
        unless given (a mesh builds its own in _stage_tables)."""
        msm = msm if msm is not None else MsmPlan(self.ns)
        return msm, srs_em if srs_em is not None else \
            msm.prepare_points(self.srs)

    def _stage_tables(self):
        """Place the tables and the SRS after _build_tables (no-op on one
        device; a mesh shards them)."""

    def _device_width(self, ns: int) -> int:
        """Width of SRS-length buffers (a mesh: a multiple of its
        shards)."""
        return ns

    def _whole(self, x):
        """The whole of an intermediate on this engine's device, for the
        steps that run unsharded (no-op on one device; a mesh gathers)."""
        return x

    # -- one-time table construction --------------------------------------------------

    def _build_tables(self):
        F, n, n8, dev = self.F, self.n, self.n8, self.device
        # 16 n-degree polys padded to 8n: 11 selectors, 4 sigmas, L1
        e1 = torch.zeros((16, n), dtype=torch.int32, device=dev)
        e1[:, :1] = F.const("one_mont", dev)
        l1_poly = self.plan_n.idft(e1)
        polys = torch.cat([self.sel_polys, self.sigma_polys, l1_poly[None]])
        pad8 = torch.nn.functional.pad(polys, (0, n8 - n))
        evs = self.plan_8n.coset_dft(pad8)                     # (16, 16, n8)
        self.sel8, self.sig8, self.l1_8 = evs[:11], evs[11:15], evs[15]
        # sigma evals over the n domain (round-2 denominators)
        self.sigma_evals_n = self.plan_n.dft(self.sigma_polys)

        # coset vanishing inverse: (g w8n^i)^n - 1 has period n8 / n
        period = n8 // n
        g_n = pow(FR_GENERATOR, n, R_MOD)
        w_n = pow(fr_root_of_unity(self.k8), n, R_MOD)
        vals = []
        cur = g_n
        for _ in range(period):
            vals.append(pow((cur - 1) % R_MOD, -1, R_MOD))
            cur = cur * w_n % R_MOD
        self.vh_inv8 = F.pack(vals, dev).repeat(1, n8 // period)

        # linear table X over the coset: g * w8n^i
        self.lin8 = F.powers_host_base(fr_root_of_unity(self.k8), n8, dev,
                                       scale=FR_GENERATOR)
        # domain roots (round 2) and coset K constants
        self.roots_n = F.powers_host_base(fr_root_of_unity(self.k), n, dev)
        spec = F.spec
        self.ks = torch.from_numpy(np.stack([int_to_limbs(
            spec, v * spec.mont_r % spec.modulus)[:, None]
            for v in (1, PERM_K1, PERM_K2, PERM_K3)])).to(dev)  # (4, 16, 1)

    # -- round helpers ----------------------------------------------------------------

    def _blind_into(self, poly, blinders, width):
        """Place an n-coeff poly (..., 16, n) into a width buffer and add
        (sum b_i X^i)(X^n - 1); blinders (..., 16, h+1)."""
        F, n = self.F, self.n
        buf = torch.nn.functional.pad(poly, (0, width - n))
        for i in range(blinders.shape[-1]):
            b = blinders[..., i:i + 1]
            buf[..., n + i:n + i + 1] = F.add(buf[..., n + i:n + i + 1], b)
            buf[..., i:i + 1] = F.sub(buf[..., i:i + 1], b)
        return buf

    def _commit_batch(self, canon_stack):
        """(B, 16, ns) canonical coefficient stack -> B affine points."""
        return self.msm.msm_affine_batch(self.srs_em, canon_stack)

    def _round1(self, wire_vals, blinders):
        polys = self._t_n(wire_vals, "idft")
        bufs = self._blind_into(polys, blinders, self.nsd)
        return bufs, self.F.from_mont(bufs)

    def _perm_products(self, wire_vals, roots, sigma_evals, ks, beta, gamma):
        """Round 2's numerator and denominator products over the n domain
        (or one shard of it)."""
        F = self.F
        bx = F.mul(beta, roots)                                     # (16, n)
        num = F.add(F.add(wire_vals, F.mul(ks, bx)), gamma)
        den = F.add(F.add(wire_vals, F.mul(beta, sigma_evals)), gamma)
        nprod = F.mul(F.mul(num[0], num[1]), F.mul(num[2], num[3]))
        dprod = F.mul(F.mul(den[0], den[1]), F.mul(den[2], den[3]))
        return nprod, dprod

    def _round2(self, wire_vals, beta, gamma, blinders):
        """-> z(X) blinded at width nsd, and its canonical (1, 16, nsd)
        commit batch."""
        F, n = self.F, self.n
        nprod, dprod = self._perm_products(
            wire_vals, self.roots_n, self.sigma_evals_n, self.ks, beta, gamma)
        ratio = F.mul(nprod, self._batch_inv(dprod))
        incl = self._prefix_mul(ratio)
        z = torch.cat([F.const("one_mont", self.device), incl[..., :n - 1]],
                      dim=-1)
        z_poly = self._t_n(z, "idft")
        buf = self._blind_into(z_poly, blinders, self.nsd)
        return buf, F.from_mont(buf[None])

    def _round3_decomposed(self, wire_polys, z_poly, pi_dense, consts):
        """K14's constant table -> t(X) coefficients (8n): the six coset
        evaluations, the quotient grid in one K14 launch (unchunked, E =
        n8; the next gate wraps to the coset's first 8 points), its
        inverse transform."""
        n8 = self.n8
        pi_poly = self._t_n(pi_dense, "idft")

        def pad8(x):
            return torch.nn.functional.pad(x, (0, n8 - x.shape[-1]))

        batch = torch.cat(
            [pad8(z_poly)[None], pad8(wire_polys), pad8(pi_poly)[None]])
        evs = self._t_8n(batch, "coset_dft")
        halo = evs[[0, 1, 2, 4], :, :8].contiguous()
        t = kernels.quotient(self.F, evs, halo, self.sel8, self.sig8,
                             self.l1_8, self.lin8, self.vh_inv8, consts)
        return self._t_8n(t, "coset_idft")

    def _round3c(self, t_coeffs):
        """t(X) -> four (16, nsd) chunks (+ canonical copy) and the SRS-degree
        check: nonzero coefficients past 3n + ns mean an unsatisfied
        circuit (the reference errors at the t_4 commit)."""
        F, n, ns = self.F, self.n, self.ns
        tail_bad = bool((t_coeffs[..., 3 * n + ns:] != 0).any())
        chunks = torch.zeros((4, F.L, self.nsd), dtype=torch.int32,
                             device=self.device)
        for i in range(3):
            chunks[i, :, :n] = t_coeffs[..., i * n:(i + 1) * n]
        top = t_coeffs[..., 3 * n:3 * n + ns]
        chunks[3, :, :top.shape[-1]] = top
        return chunks, F.from_mont(chunks), tail_bad

    def _pad_nsd(self, x):
        return torch.nn.functional.pad(x, (0, self.nsd - x.shape[-1]))

    def _evals(self, wire_polys, z_poly, chunks, z_ch, zw):
        F, n = self.F, self.n
        powz = F.powers(z_ch, self.nsd)
        powzw = F.powers(zw, self.nsd)
        # at z: a, b, c, d, sigma1..3, q_arith, q_c, q_l, q_r (11 polys)
        sel_idx = [SELECTOR_NAMES.index(k) for k in ("q_arith", "q_c", "q_l",
                                                "q_r")]
        at_z = torch.cat([wire_polys, self._pad_nsd(self.sigma_polys[:3]),
                          self._pad_nsd(self.sel_polys[sel_idx])])
        ev_z = F.dot(at_z, powz)                                 # (11, 16, 1)
        at_zw = torch.cat([wire_polys[[0, 1, 3]], z_poly[None]])
        ev_zw = F.dot(at_zw, powzw)                              # (4, 16, 1)
        # t_eval: fold chunks by z^n powers, then evaluate
        zn = powz[..., n:n + 1]
        z2n = F.mul(zn, zn)
        z3n = F.mul(z2n, zn)
        w_ = torch.stack([F.const("one_mont", self.device), zn, z2n, z3n])
        quot = F.sum_reduce(F.mul(chunks, w_), axis=0)           # (16, nsd)
        t_eval = F.dot(quot, powz)
        ev_all = torch.cat([ev_z, ev_zw, t_eval[None]])          # (16, 16, 1)
        return ev_all, quot, powz

    def _rpoly(self, z_poly, lin_scalars, powz):
        F = self.F
        order_idx = [SELECTOR_NAMES.index(k) for k in LIN_ORDER[:10]]
        srcs = torch.cat([self._pad_nsd(self.sel_polys[order_idx]),
                          z_poly[None],
                          self._pad_nsd(self.sigma_polys[3:4])])  # (12, 16, nsd)
        r = F.sum_reduce(F.mul(srcs, lin_scalars), axis=0)      # (16, nsd)
        return r, F.dot(r, powz)

    def _divide_out(self, folded, point):
        """(folded - folded(point)) / (X - point) by an affine-map scan:
        acc_k = point acc_{k-1} + g_k over reversed coefficients
        (Hillis-Steele over (multiplier, offset) pairs)."""
        F = self.F
        g = folded.flip(-1)
        a = point.expand(g.shape)
        m = g.shape[-1]
        idx = torch.arange(m, device=g.device)
        for i in range((m - 1).bit_length()):
            sh = 1 << i
            a_sh = torch.roll(a, sh, dims=-1)
            b_sh = torch.roll(g, sh, dims=-1)
            live = idx >= sh
            a, g = (torch.where(live, F.mul(a_sh, a), a),
                    torch.where(live, F.add(F.mul(b_sh, a), g), g))
        q = g[..., :-1].flip(-1)
        return torch.nn.functional.pad(q, (0, 1))

    def _openings(self, quot, r_poly, wire_polys, z_poly, z_ch, zw, v1, v2):
        F = self.F
        group1 = torch.cat([quot[None], r_poly[None], wire_polys,
                            self._pad_nsd(self.sigma_polys[:3])])  # (9, 16, nsd)
        w1 = F.powers(v1, 9).movedim(-1, 0)[..., None]          # (9, 16, 1)
        agg1 = self._divide_out(F.sum_reduce(F.mul(group1, w1), axis=0),
                                z_ch)
        group2 = torch.cat([z_poly[None], wire_polys[[0, 1, 3]]])
        w2 = F.powers(v2, 4).movedim(-1, 0)[..., None]
        agg2 = self._divide_out(F.sum_reduce(F.mul(group2, w2), axis=0), zw)
        both = torch.stack([agg1, agg2])
        return both, F.from_mont(both)

    # -- the proof ---------------------------------------------------------------------

    def create_proof(self, prover, rng, circuit):
        F, n, dev = self.F, self.n, self.device
        mark = Marks(dev)

        cs = self._synthesize_fast(circuit)
        mark("synthesize")

        transcript = prover.transcript.clone()
        public_inputs = cs.instance_values()
        pi_indexes = cs.public_input_indexes()
        for pi in public_inputs:
            transcript.append_scalar(b"pi", pi)
        pi_dense = self._stage_dom(F.pack_sparse(
            list(zip(pi_indexes, public_inputs)), n, dev))

        # ---- round 1 -----------------------------------------------------------
        wire_vals = self._stage_dom(kernels.wire_gather(
            F, self._wit_table, self._wire_cols))
        mark("wire_pack")
        blinders1 = F.pack([fr_random(rng) for _ in range(4 * 2)], dev,
                           shape=(4, 2))
        wire_polys, wire_canon = self._round1(wire_vals, blinders1)
        commits = self._commit_batch(wire_canon)
        for label, comm in zip((b"a_w", b"b_w", b"c_w", b"d_w"), commits):
            transcript.append_commitment(label, comm)
        a_comm, b_comm, c_comm, d_comm = commits
        mark("round1")

        # ---- round 2 -----------------------------------------------------------
        beta = transcript.challenge_scalar(b"beta")
        transcript.append_scalar(b"beta", beta)
        gamma = transcript.challenge_scalar(b"gamma")
        blinders2 = F.pack([fr_random(rng) for _ in range(3)], dev)
        z_poly, z_canon = self._round2(
            wire_vals, F.pack_scalar(beta, dev), F.pack_scalar(gamma, dev),
            blinders2)
        z_comm = self._commit_batch(z_canon)[0]
        transcript.append_commitment(b"z", z_comm)
        mark("round2")

        # ---- round 3 -----------------------------------------------------------
        alpha = transcript.challenge_scalar(b"alpha")
        range_sep = transcript.challenge_scalar(
            b"range separation challenge")
        logic_sep = transcript.challenge_scalar(
            b"logic separation challenge")
        fixed_base_sep = transcript.challenge_scalar(
            b"fixed base separation challenge")
        var_base_sep = transcript.challenge_scalar(
            b"variable base separation challenge")
        ch_host = dict(alpha=alpha, beta=beta, gamma=gamma,
                       range_sep=range_sep, logic_sep=logic_sep,
                       fixed_base_sep=fixed_base_sep,
                       var_base_sep=var_base_sep)
        consts = kernels.quotient_consts(F, ch_host, dev)
        t_coeffs = self._round3_decomposed(wire_polys, z_poly, pi_dense,
                                           consts)
        chunks, chunks_canon, tail_bad = self._round3c(self._whole(t_coeffs))
        # the reference's error surfaces before any t commitment is absorbed
        if tail_bad:
            raise Error("polynomial degree exceeds SRS (unsatisfied circuit)")
        t_commits = self._commit_batch(chunks_canon)
        for label, comm in zip((b"t_low", b"t_mid", b"t_high", b"t_4"),
                               t_commits):
            transcript.append_commitment(label, comm)
        mark("round3")

        # ---- rounds 4 + 5 --------------------------------------------------------
        z_challenge = transcript.challenge_scalar(b"z_challenge")
        zw = z_challenge * self.pk.domain.generator % R_MOD
        # rounds 4 and 5 run whole on one device (a mesh gathers)
        wire_polys, z_poly = self._whole(wire_polys), self._whole(z_poly)
        ev_all, quot, powz = self._evals(
            wire_polys, z_poly, chunks, F.pack_scalar(z_challenge, dev),
            F.pack_scalar(zw, dev))
        ea = F.unpack(ev_all)                  # one fetch for 16 scalars
        ez, ezw, t_eval = ea[:11], ea[11:15], ea[15]
        evals = {
            "a_eval": ez[0], "b_eval": ez[1], "c_eval": ez[2],
            "d_eval": ez[3],
            "s_sigma_1_eval": ez[4], "s_sigma_2_eval": ez[5],
            "s_sigma_3_eval": ez[6],
            "q_arith_eval": ez[7], "q_c_eval": ez[8], "q_l_eval": ez[9],
            "q_r_eval": ez[10],
            "a_next_eval": ezw[0], "b_next_eval": ezw[1],
            "d_next_eval": ezw[2], "perm_eval": ezw[3],
        }
        mark("evals")

        z_h_eval = (pow(z_challenge, n, R_MOD) - 1) % R_MOD
        l1_eval = compute_first_lagrange_eval(n, z_h_eval, z_challenge)
        scalars = widgets.linearization_scalars(
            evals, ch_host, l1_eval, z_challenge)
        if tuple(k for k, _ in scalars) != LIN_ORDER:
            raise RuntimeError("linearization scalar order changed")
        lin_scalars = F.pack([s for _, s in scalars], dev, shape=(12, 1))
        r_poly, r_eval = self._rpoly(z_poly, lin_scalars, powz)
        evals["r_poly_eval"] = F.unpack(r_eval)[0]
        mark("rpoly")

        for label, key in EVAL_TRANSCRIPT_ORDER:
            transcript.append_scalar(label, evals[key])
        transcript.append_scalar(b"t_eval", t_eval)
        transcript.append_scalar(b"r_eval", evals["r_poly_eval"])

        # ---- openings (v_challenge drawn twice back to back, as the
        # reference does) ---------------------------------------------------------
        v_challenge = transcript.challenge_scalar(b"v_challenge")
        v_shifted = transcript.challenge_scalar(b"v_challenge")
        _, aggs_canon = self._openings(
            quot, r_poly, wire_polys, z_poly, F.pack_scalar(z_challenge, dev),
            F.pack_scalar(zw, dev), F.pack_scalar(v_challenge, dev),
            F.pack_scalar(v_shifted, dev))
        w_z_chall_comm, w_z_chall_w_comm = self._commit_batch(aggs_canon)
        mark("openings")
        self.last_timings = mark.times
        self.last_peaks = mark.peaks
        for label, seconds in mark.times.items():
            tracer.add_span("prove." + label, seconds)

        proof = Proof(
            a_comm=a_comm, b_comm=b_comm, c_comm=c_comm, d_comm=d_comm,
            z_comm=z_comm,
            t_low_comm=t_commits[0], t_mid_comm=t_commits[1],
            t_high_comm=t_commits[2], t_4_comm=t_commits[3],
            w_z_chall_comm=w_z_chall_comm,
            w_z_chall_w_comm=w_z_chall_w_comm,
            evaluations=evals)
        return proof, public_inputs
