"""Pippenger multi-scalar multiplication (the KZG commit engine).

Counterpart of dusk_plonk_tpu/ops/msm.py in its default configuration
(`ec_limb14=True`: one kernel launch for each step of the bucket phase),
with the 14-bit kernels merged into the port's one limb engine:

  1. signed c-bit window digits, |d| <= 2^(c-1), from the scalar limbs;
  2. per (commit, window) row, ONE torch.sort of an int64 key that packs
     (|digit|, sign, index): equal digits become contiguous runs;
  3. a gather from the element-major point table (row i = (x_i, y_i), row
     n_pad + i = (x_i, -y_i): the digit sign folds into the index) into
     (cl, 48, lanes), then kernel K11a: a chunked inclusive prefix scan of
     mixed additions, one lane per (row, chunk); with `config.ec_scan_em`
     kernel K12, the same scan with element-major output (cl, lanes, 72),
     as dusk_plonk_tpu/ops/msm.py:289-291 routes it;
  4. chunk offsets: kernel K4, the exclusive prefix of each row's chunk
     totals, one lane per row (a block-parallel scan over its chunks);
  5. the telescoped bucket reduction
       sum_d d B_d = NB P(N-1) - sum_{d<NB} P(t_d),
     with t_d from torch.searchsorted, the prefix reads P(t) = scan value +
     chunk offset on K9 (under K12 each scan value is one contiguous
     72-word row), both levels of the bucket sum on K11b and
     NB * full_sum - sum on K7;
  6. the window combine: on the host in C++ (native.g1_combine_windows)
     for the prover's commits, as the JAX prover does, or kernel K8 on the
     device (`msm_device`, the JAX package's bench MSM).

The commit batch B rides in the row axis (B * W rows, commit-major), so a
kernel launch covers many commits at once.  Steps 2-5 hold ~640 bytes of
device memory a (row, point) slot, so the rows go through them in
balanced groups of at most `config.msm_group_slots // n_pad` rows
(`MsmPlan._row_groups`): the one knob stands in for the JAX package's
window groups and its `max_fused` commit cap (dusk_plonk_tpu/ops/msm.py:
93-104, 673-709).  Rows are independent, so a group's totals are the same
points; only K11b's block shape, which depends on the lane count, may give
other projective representatives.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils.config import get_config
from ..utils.tracing import tracer
from .ec import device_g1
from .limb import fq_field

MAX_WINDOW_BITS = 13


def pick_window_bits(n: int) -> int:
    """c ~ log2(n) - 4, clamped (ops/msm.py::pick_window_bits)."""
    return max(2, min(MAX_WINDOW_BITS, n.bit_length() - 4))


class MsmPlan:
    """MSM over a fixed point count n (the points are an input)."""

    def __init__(self, n: int, window_bits: int | None = None):
        self.n = n
        self.G1 = device_g1()
        self.Fq = fq_field()
        cfg = get_config()
        c = window_bits if window_bits is not None else \
            (cfg.msm_window_bits or pick_window_bits(n))
        if not 2 <= c <= 16:
            raise ValueError(f"msm window_bits must be in [2, 16], got {c}")
        self.window_bits = c
        # ceil(257 / c) windows: the top window absorbs the signed-digit
        # carry, since scalars are < 2^255
        self.num_windows = -(-257 // c)
        self.nb = 1 << (c - 1)
        self.chunk_len = min(cfg.msm_chunk_len, n)
        self.scan_em = cfg.ec_scan_em
        self.group_slots = cfg.msm_group_slots
        # pad to a chunk multiple: zero scalars sort into bucket 0, which
        # the reduction never reads
        self.n_pad = -(-n // self.chunk_len) * self.chunk_len

    # -- digits --------------------------------------------------------------

    def _digits(self, limbs):
        """(B, 16, N) canonical 16-bit limbs -> (B, W, N) int64 signed
        digits with scalar = sum_w d_w 2^(c w).  int64 throughout:
        limb << (16 - s) overflows int32."""
        wb = self.window_bits
        x = limbs.long()
        mask = (1 << wb) - 1
        raw = []
        for w in range(self.num_windows):
            o = wb * w
            i, s = o >> 4, o & 15
            if i >= 16:
                raw.append(torch.zeros_like(x[:, 0]))
                continue
            d = x[:, i] >> s
            if s + wb > 16 and i + 1 < 16:
                d = d | (x[:, i + 1] << (16 - s))
            raw.append(d & mask)
        half = 1 << (wb - 1)
        out = []
        carry = torch.zeros_like(raw[0])
        for w in range(self.num_windows):
            t = raw[w] + carry
            neg = t >= half
            out.append(torch.where(neg, t - 2 * half, t))
            carry = neg.long()
        return torch.stack(out, dim=1)

    # -- element-major point table -------------------------------------------

    def prepare_points(self, points):
        """((24, n),)*3 affine points (z = 1) -> the (2 n_pad, 48)
        element-major table: row i = (x_i, y_i), row n_pad + i =
        (x_i, -y_i); pads are the affine generator (scalar 0)."""
        px, py, _ = points
        if self.n_pad != self.n:
            gx, gy = self.G1.generator_affine(px.device)
            pad = self.n_pad - self.n
            px = torch.cat([px, gx.expand(24, pad)], dim=-1)
            py = torch.cat([py, gy.expand(24, pad)], dim=-1)
        em = torch.cat([torch.cat([px, py], dim=0),
                        torch.cat([px, self.Fq.neg(py)], dim=0)], dim=-1)
        return em.T.contiguous()

    # -- window totals -----------------------------------------------------------

    def _window_totals(self, em, digits):
        """digits (R, N) signed (R = commits x windows) -> per-row window
        totals ((24, R),)*3, projective Montgomery."""
        G1 = self.G1
        dev = digits.device
        R, n = digits.shape
        cl = self.chunk_len
        nc = n // cl
        lanes = R * nc

        shift = (n - 1).bit_length()
        key = (digits.abs() << (shift + 1)) | ((digits < 0).long() << shift) \
            | torch.arange(n, device=dev)
        skey = torch.sort(key, dim=-1).values
        order = skey & ((1 << shift) - 1)
        ssign = (skey >> shift) & 1
        sd = (skey >> (shift + 1)).contiguous()                # sorted |d|

        g = em[order + n * ssign]                              # (R, N, 48)
        g = g.reshape(R, nc, cl, 48).permute(2, 3, 0, 1).reshape(
            cl, 48, lanes).contiguous()
        # chunk offsets: exclusive prefix of each row's chunk totals, K4
        # over (nc steps, R lanes)
        if self.scan_em:
            ps_em = G1.scan_mixed_em(g)                        # K12
            last = ps_em[-1].reshape(R, nc, 72).permute(1, 2, 0)
            seq = tuple(last[:, 24 * i:24 * (i + 1)].contiguous()
                        for i in range(3))                     # (nc, 24, R)
        else:
            ps = G1.scan_mixed(g)                              # K11a
            seq = tuple(c[-1].reshape(24, R, nc).permute(2, 0, 1)
                        .contiguous() for c in ps)             # (nc, 24, R)
        offsets = tuple(c.permute(1, 2, 0).reshape(24, lanes)
                        for c in G1.scan_excl(seq))            # (24, R*nc)

        # bucket tails t_d = last sorted index with |digit| <= d, and the
        # full-sum index n - 1, read as scan value + chunk offset (K9)
        NB = self.nb
        buckets = torch.arange(NB, device=dev).expand(R, NB).contiguous()
        tails = torch.searchsorted(sd, buckets, right=True) - 1
        idx = torch.cat([tails, torch.full((R, 1), n - 1, device=dev,
                                           dtype=torch.long)], dim=-1)
        M = NB + 1
        neg, vals, offs = self._tail_reads(idx, ps_em if self.scan_em
                                           else ps, offsets, nc)
        pts = G1.select(neg, G1.broadcast_identity((), R * M, dev),
                        G1.add(vals, offs))                    # (24, R*M)
        grid = tuple(c.reshape(24, R, M) for c in pts)
        full_sum = tuple(c[..., NB].contiguous() for c in grid)   # (24, R)

        # two-level sum over the NB bucket tails, each level one K11b
        # launch: sb steps on R * sa lanes, then sa steps on R lanes
        sa = 1 << ((self.window_bits - 1) // 2)
        sb = NB // sa
        lvl1 = tuple(c[..., :NB].reshape(24, R, sa, sb).permute(3, 0, 1, 2)
                     .reshape(sb, 24, R * sa).contiguous() for c in grid)
        acc = G1.sum_steps(lvl1)                               # (24, R*sa)
        lvl2 = tuple(c.reshape(24, R, sa).permute(2, 0, 1).contiguous()
                     for c in acc)                             # (sa, 24, R)
        cur = G1.sum_steps(lvl2)                               # (24, R)

        # total = NB * full_sum - sum_d P(t_d), one K7 launch
        return G1.double_add(full_sum, G1.neg(cur), NB.bit_length() - 1)

    def _tail_reads(self, idx, ps, offsets, nc):
        """idx (R, M) prefix indices into each row's sorted points (-1:
        none) -> (neg, vals, offs): which reads are the identity, and the
        scan values and chunk offsets that K9 adds, ((24, R*M),)*3 each.
        `ps` is K11a's output ((cl, 24, R*nc),)*3, or under scan_em K12's
        (cl, R*nc, 72); `offsets` K4's ((24, R*nc),)*3."""
        R = idx.shape[0]
        cl = self.chunk_len
        lanes = R * nc
        neg = (idx < 0).reshape(-1)
        safe = idx.clamp(min=0)
        pi = (safe % cl).reshape(-1)
        lane = (torch.arange(R, device=idx.device)[:, None] * nc
                + safe // cl).reshape(-1)
        if self.scan_em:
            rows = ps.reshape(cl * lanes, 72)[pi * lanes + lane]
            vals = tuple(rows[:, 24 * i:24 * (i + 1)].T.contiguous()
                         for i in range(3))                    # (24, R*M)
        else:
            vals = tuple(c[pi, :, lane].T.contiguous() for c in ps)
        offs = tuple(c[:, lane].contiguous() for c in offsets)
        return neg, vals, offs

    # -- public ------------------------------------------------------------------

    def _row_groups(self, R: int):
        """The row groups of an R-row batch: the fewest balanced groups of
        at most max(1, group_slots // n_pad) rows, larger groups first,
        as (start, stop) pairs covering 0..R in order.  Shapes and config
        alone set them."""
        cap = max(1, self.group_slots // self.n_pad)
        G = -(-R // cap)
        size, extra = divmod(R, G)
        out, start = [], 0
        for i in range(G):
            stop = start + size + (i < extra)
            out.append((start, stop))
            start = stop
        return out

    def window_totals(self, em, limbs_stack):
        """limbs_stack (B, 16, n) canonical -> LSB-first window totals,
        ((24, B * W),)*3 projective Montgomery, commit-major; the rows run
        in `_row_groups`."""
        B = limbs_stack.shape[0]
        if self.n_pad != self.n:
            limbs_stack = torch.nn.functional.pad(
                limbs_stack, (0, self.n_pad - self.n))
        digits = self._digits(limbs_stack).reshape(
            B * self.num_windows, self.n_pad)
        parts = [self._window_totals(em, digits[a:b])
                 for a, b in self._row_groups(digits.shape[0])]
        return tuple(torch.cat(c, dim=-1) for c in zip(*parts))

    def msm_device(self, em, limbs):
        """em: a prepare_points table; limbs (16, n) or (B, 16, n)
        canonical scalar limbs.  Returns the B results as projective
        ((24, B),)*3 device points: the window totals, then the window
        combine on the device (kernel K8, one lane per MSM).  K8 starts
        from the top window's total and doubles with RCB15's doubling, so
        the representative differs from the JAX kernel's: compare in
        affine form."""
        if limbs.dim() == 2:
            limbs = limbs[None]
        B, W = limbs.shape[0], self.num_windows
        tracer.count("msm_dispatch")
        tracer.count("msm_points", self.n * B)
        tot = self.window_totals(em, limbs)
        msb = tuple(c.reshape(24, B, W).flip(-1).permute(2, 0, 1)
                    .contiguous() for c in tot)                # (W, 24, B)
        return self.G1.combine(msb, self.window_bits)

    def msm_affine_batch(self, em, limbs_stack):
        """em: a prepare_points table; limbs_stack (B, 16, n) canonical
        scalar limbs.  Returns B affine host points ((x, y) or None)."""
        B, W = limbs_stack.shape[0], self.num_windows
        tracer.count("msm_dispatch")
        tracer.count("msm_points", self.n * B)
        tot = self.window_totals(em, limbs_stack)
        arrs = [c.T.reshape(B, W, 24).cpu().numpy().astype("<u2")
                for c in tot]                                  # (B, W, 24)
        buf = np.stack(arrs, axis=2)                           # (B, W, 3, 24)
        return native.g1_combine_windows(
            buf.tobytes(), B, self.num_windows, self.window_bits)
