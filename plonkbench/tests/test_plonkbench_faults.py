"""A run with the timed path broken underneath reads `correct` false, and
so does the control: the program with its blinders all zero, which breaks
the configuration's zero-knowledge guarantee while every proof still
verifies.  These drive harness.run on the CPU at a tiny size, past run.py's
look for a card.  The control at the cells' own sizes, on three seeds, is
the `chip` test at the end."""

import pytest
import torch

from conftest import run_cell

CELL = "tiny_stream"


class ZeroRng:
    """A blinder stream of zeros: every Fr draw is 0."""

    def fill_bytes(self, n):
        return bytes(n)


def _zero_rng(seed):
    return ZeroRng()


def test_a_sound_run_is_correct(tiny_root):
    result, checks = run_cell(tiny_root, CELL, 2 ** 31 + 3)
    assert result["correct"], checks
    assert sum(checks.values()) == 0
    assert result["attempted"] >= 1 and result["failed"] == 0


def _step_unchanged(monkeypatch):
    """A step that returns its state unchanged: every n-domain inverse
    transform of a proof."""
    from dusk_plonk_torch.proving.engine import TorchEngine
    orig = TorchEngine._t_n

    def t_n(self, x, kind):
        return x if kind == "idft" else orig(self, x, kind)

    monkeypatch.setattr(TorchEngine, "_t_n", t_n)


def _half_batch(monkeypatch):
    """Half of each commit batch left out: its first half computed, the
    rest copies of it."""
    from dusk_plonk_torch.proving.engine import TorchEngine
    orig = TorchEngine._commit_batch

    def commit(self, stack):
        half = orig(self, stack[:(stack.shape[0] + 1) // 2])
        return [half[i % len(half)] for i in range(stack.shape[0])]

    monkeypatch.setattr(TorchEngine, "_commit_batch", commit)


def _quotient_altered(monkeypatch):
    """An answer altered where it is produced: one limb of the quotient
    grid's output."""
    from dusk_plonk_torch.ops import kernels
    orig = kernels.quotient

    def quotient(*args):
        t = orig(*args).clone()
        t[0, 5] ^= 1
        return t

    monkeypatch.setattr(kernels, "quotient", quotient)


def _evaluation_altered(monkeypatch):
    """An answer altered where it is produced: one evaluation at z."""
    from dusk_plonk_torch.proving.engine import TorchEngine
    orig = TorchEngine._evals

    def evals(self, *args):
        ev_all, quot, powz = orig(self, *args)
        ev_all = ev_all.clone()
        ev_all[2, 0, 0] ^= 1
        return ev_all, quot, powz

    monkeypatch.setattr(TorchEngine, "_evals", evals)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch,
                                   _quotient_altered, _evaluation_altered])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    result, checks = run_cell(tiny_root, CELL, 2 ** 31 + 5)
    assert not result["correct"]
    assert sum(checks.values()) > 0


def test_the_control_is_not_correct(tiny_root):
    result, checks = run_cell(tiny_root, CELL, 2 ** 31 + 7,
                              prove_rng=_zero_rng)
    assert not result["correct"]
    assert checks["commit_mismatch"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("cell, seconds", [("k16_bench_stream", 4.0),
                                           ("k20_bench_stream", 8.0)])
def test_the_control_at_the_cells_size(cuda_card, cell, seconds, capsys):
    """The control on the card at the cell's size on three seeds: every
    run reads `correct` false; the readings go to standard output."""
    from conftest import ROOT
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        result, checks = run_cell(ROOT, cell, seed, seconds=seconds,
                                  device=cuda_card, prove_rng=_zero_rng)
        with capsys.disabled():
            print(f"control {cell} seed {seed}: correct "
                  f"{result['correct']} {checks}")
        assert not result["correct"]
        torch.cuda.empty_cache()
