"""The benchmark's operation and byte counts against hand values."""

import pytest

from benchmark.counts import (potrf, potrf_stream_f32, potri, trsm,
                              trtri_stream_f32)


@pytest.mark.parametrize("n, flops", [(1, 1.0), (2, 5.0), (3, 14.0),
                                      (10, 385.0), (8192, 183285493760.0)])
def test_potrf(n, flops):
    # n³/3 + n²/2 + n/6 = n(n + 1)(2n + 1)/6, the sum of squares
    assert potrf.flops(n) == pytest.approx(flops, rel=1e-12)
    assert potrf.flops(n) == pytest.approx(n * (n + 1) * (2 * n + 1) / 6,
                                           rel=1e-12)


@pytest.mark.parametrize("n, flops", [(1, 2.0), (2, 9.0), (3, 25.0)])
def test_potri(n, flops):
    assert potri.flops(n) == pytest.approx(flops, rel=1e-12)


def test_trsm():
    assert trsm.flops(8192, 1) == 8192 ** 2
    assert trsm.flops(8192, 821) == 8192 ** 2 * 821


def test_kernel_counts():
    n = 8192
    assert potrf_stream_f32.ops(n) == potrf.flops(n)
    assert trtri_stream_f32.ops(n) == pytest.approx(n ** 3 / 3 + 2 * n / 3)
    # the lower triangle read once, the whole matrix written once
    for counts in (potrf_stream_f32, trtri_stream_f32):
        assert counts.nbytes(4) == 4 * (10 + 16)


def test_step_counts_of_the_cells():
    """The GP train step (potrf, potri, two solves of one column) and the
    predict call (potrf, solves of 2 + m columns) at n = 8192."""
    from benchmark import harness

    n = 8192
    step = harness.load("calls", "gp_train_step").Call.flops
    predict = harness.load("calls", "gp_predict").Call.flops

    class Fake:
        pass

    f = Fake()
    f.n, f.m = n, 819
    assert step(f, 0) == pytest.approx(549957148672.0, rel=1e-12)
    assert predict(f, 0) == pytest.approx(
        potrf.flops(n) + n * n * 821, rel=1e-12)


def test_roofline_share():
    from benchmark import kernel_time

    peaks = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    # operations bound: 67e9 operations take 1 ms at the peak
    assert kernel_time.share(67e9, 1.0, 2.0, peaks) == pytest.approx(50.0)
    # bytes bound: 3.35e9 bytes take 1 ms
    assert kernel_time.share(1.0, 3.35e9, 4.0, peaks) == pytest.approx(25.0)
