"""The frozen work counts at the headline shapes, the window and percentile
arithmetic, and the traffic generator."""

import math
import statistics

import pytest

from plonkbench import stats, traffic, work


def test_peak_is_the_multiply_peak():
    assert work.PEAK_PRODUCTS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert work.PEAK_BYTES_PER_S == 3.35e12


def test_quotient_least_time_at_the_headline_shapes():
    # 86 Fr multiplies of 112 products a point: 0.302 ms at (16, 2^19),
    # 4.83 ms at (16, 2^23)
    for points, ms in ((1 << 19, 0.302), (1 << 23, 4.83)):
        products, nbytes = work.quotient(points, 24)
        assert products == points * 86 * 112
        assert nbytes == 25 * points * 32
        assert work.least_seconds(products, nbytes) * 1e3 == \
            pytest.approx(ms, rel=2e-3)


@pytest.mark.parametrize("kind, scales", [
    ("dft", 0), ("idft", 1), ("coset_dft", 1), ("coset_idft", 1)])
def test_ntt_counts_butterflies_and_scales(kind, scales):
    rows, n = 6, 1 << 19
    products, nbytes = work.ntt(kind, rows, n)
    assert products == rows * (n // 2 * 19 + scales * n) * 112
    assert nbytes == 2 * rows * n * 32


def test_ntt_least_time_of_round_3_coset_dft():
    # six rows of 2^19: 0.221 ms, compute-bound
    products, nbytes = work.ntt("coset_dft", 6, 1 << 19)
    assert products / work.PEAK_PRODUCTS_PER_S > \
        nbytes / work.PEAK_BYTES_PER_S
    assert work.least_seconds(products, nbytes) * 1e3 == \
        pytest.approx(0.2211, rel=1e-3)


@pytest.mark.parametrize("points, window, adds", [
    (65_543, 12, 22 * (65_543 + 8_192)),
    ((1 << 20) + 7, 16, 16 * ((1 << 20) + 7 + 131_072)),
])
def test_msm_window_minimises_additions(points, window, adds):
    c, n_adds = work.msm_window(points)
    assert (c, n_adds) == (window, adds)
    for other in range(1, 25):
        assert math.ceil(255 / other) * (points + (1 << (other + 1))) \
            >= n_adds


def test_msm_counts_mixed_adds_of_eleven_fq_multiplies():
    products, nbytes = work.msm(4, 65_543)
    assert products == 4 * 22 * (65_543 + 8_192) * 11 * 300
    assert nbytes == 65_543 * 96 + 4 * 65_543 * 32 + 4 * 96


@pytest.mark.parametrize("values, q, want", [
    ([1.0], 90, 1.0),
    ([1.0, 2.0], 50, 1.5),
    (list(range(11)), 90, 9.0),
    (list(range(10, 0, -1)), 90, 9.1),
])
def test_percentile_interpolates_between_ranks(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_spread_uses_the_quartiles_of_statistics():
    xs = [1.0, 1.1, 1.2, 0.9, 1.05, 1.15]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) /
                                             statistics.median(xs))


def test_window_seconds_over_items():
    assert stats.seconds_per_item(10.0, [11.0, 12.0, 13.0], 3) == 1.0
    # a failed attempt adds its time and no item
    assert stats.seconds_per_item(10.0, [11.0, 12.0, 13.0], 2) == 1.5
    assert stats.seconds_per_item(0.0, [1.0], 0) is None


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union_seconds(spans) == 3.0
    assert stats.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 5.0)]


MIX = {"name": "stream", "loop": "closed",
       "inputs": "uniform_below_bound", "warmup": 1}


def test_same_seed_same_requests():
    bounds = {"x": 1 << 64}
    a = traffic.Stream(MIX, bounds, 2 ** 31 + 77)
    b = traffic.Stream(MIX, bounds, 2 ** 31 + 77)
    ra = [a.request(i) for i in range(20)]
    assert ra == [b.request(i) for i in range(20)]
    assert a.warm(0) == b.warm(0)
    assert len({r.inputs["x"] for r in ra}) == 20
    assert len({r.blinder_seed for r in ra}) == 20
    assert all(0 <= r.inputs["x"] < 1 << 64 for r in ra)
    assert a.warm(0) not in ra


def test_another_seed_other_requests():
    bounds = {"x": 1 << 64}
    a = traffic.Stream(MIX, bounds, 1)
    b = traffic.Stream(MIX, bounds, 2)
    assert {a.request(i).inputs["x"] for i in range(8)}.isdisjoint(
        {b.request(i).inputs["x"] for i in range(8)})


def test_same_seed_same_blinders():
    from plonkbench.reference.chacha import ChaCha12Rng, fr_random
    r = traffic.Stream(MIX, {"x": 256}, 5).request(3)
    draws = [[fr_random(ChaCha12Rng.seed_from_u64(r.blinder_seed))
              for _ in range(3)] for _ in range(2)]
    assert draws[0] == draws[1]


def test_bad_mixes_are_refused():
    with pytest.raises(ValueError):
        traffic.Stream(dict(MIX, loop="open"), {}, 1)
    with pytest.raises(ValueError):
        traffic.Stream(dict(MIX, inputs="fixed"), {}, 1)


def test_end_to_end_metrics_of_a_window():
    from plonkbench.harness import GIB, Record, _e2e
    req = traffic.Request(0, {}, 0)
    recs = [Record(req, 10.0, 11.0), Record(req, 11.0, 12.5),
            Record(req, 12.5, 13.0, error="Error: raised")]
    assert _e2e("proof_s", 10.0, recs, 5.0, None) == 1.5
    assert _e2e("setup_s", 10.0, recs, 5.0, None) == 5.0
    assert _e2e("peak_mem_gib", 10.0, recs, 5.0, 3 * GIB) == 3.0
    with pytest.raises(KeyError):
        _e2e("latency_p50_s", 10.0, recs, 5.0, None)
