"""The float64 cell ``dpotrf-dpotri-8192``: its count, its two readers on
made-up spans and on a program without the d tier's spans, and its
check on the CPU at a size a test run holds (the sound run correct; the
float32 control, and an inverse altered in one entry, not correct)."""

from types import SimpleNamespace

import pytest
import torch

import cholesky_tpu_torch as ct
from benchmark import compare, harness, readings
from benchmark.counts import mm_groups_f32pair, potrf, potri
from cholesky_tpu_torch.utils import profiling

CELL = "dpotrf-dpotri-8192"
SEED = 2 ** 31 + 2020
PEAKS = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
INT8 = 1979e12


class Event:
    """A CUDA event's stand-in: recorded at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def span(sid, name, parent, start, end, attrs=None, device=None):
    """A kept span of call 1, host times in µs, device (start, end) ms."""
    return profiling.Span(
        name, sid, parent, 1, start * 1000, end * 1000, attrs,
        None if device is None else [Event(device[0]), Event(device[1])])


LEAF = {"slices": 6, "m": 128, "n": 128, "k": 128}
CUBE = {"slices": 6, "m": 4096, "n": 4096, "k": 4096}
#: one d call: dpotrf's driver, a leaf with a peel and a product, a
#: product outside any leaf, a rescue; then dpotri's api span
WINDOW = [
    span(1, "api.potrf", None, 0, 100),
    span(2, "driver.potrf_lower", 1, 5, 95),
    span(3, "ozaki.potf2", 2, 10, 40, {"n": 128}),
    span(4, "ozaki.split", 3, 12, 20, {"m": 128, "k": 128, "slices": 6}),
    span(5, "kernel.peel_f32pair", 4, 14, 18),
    span(6, "ozaki.product", 3, 22, 35, {"m": 128, "n": 128, "k": 128}),
    span(7, "kernel.mm_groups_f32pair", 6, 25, 30, LEAF, (0.0, 0.01)),
    span(8, "ozaki.product", 2, 50, 80, {"m": 4096, "n": 4096, "k": 4096}),
    span(9, "kernel.mm_groups_f32pair", 8, 55, 60, CUBE, (1.0, 3.0)),
    span(10, "kernel.mm_groups_f32pair", 8, 61, 62, CUBE),   # no events
    span(11, "ozaki.rescue", 2, 85, 90),
]


def fake_run(name, got, calls=2, peaks=PEAKS):
    return SimpleNamespace(probes={name: SimpleNamespace(spans=got)},
                           window=SimpleNamespace(calls=calls), peaks=peaks)


def test_the_cell_counts_dpotrf_and_dpotri():
    n = 8192
    call = harness.load("calls", "dpotri").Call
    f = SimpleNamespace(A=[torch.empty(1).expand(n, n)] * 2,
                        _pick=lambda i: i % 2)
    assert call.flops(f, 0) == pytest.approx(n ** 3 + n ** 2 + n, rel=1e-12)
    assert call.flops(f, 0) == pytest.approx(
        potrf.flops(n) + potri.flops(n), rel=1e-12)
    assert call.flops(f, 0) == pytest.approx(5.4982e11, rel=1e-4)


def test_the_product_count_gives_the_bound_at_4096_cubed():
    # S(S + 1)/2 = 21 int8 products of 2·4096³: 1.4584 ms at 1979 TOP/s
    args = (6, 4096, 4096, 4096)
    assert mm_groups_f32pair.ops(*args) == 21 * 2 * 4096 ** 3
    assert mm_groups_f32pair.ops(*args) / INT8 * 1e3 == pytest.approx(
        1.4584, abs=5e-5)
    assert mm_groups_f32pair.nbytes(*args) == 6 * 8192 * 4096 + 8 * 4096 ** 2
    # operations bound: the bytes take under a tenth of the time
    assert mm_groups_f32pair.nbytes(*args) / 3.35e12 < 0.1 * 1.4584e-3


def test_ozaki_host_ms_reads_the_self_time_of_the_ozaki_spans():
    reader = harness.reader("ozaki_host_ms")
    # potf2 30 − 8 − 13, split 8 − 4, product 13 − 5, product 30 − 5 − 1,
    # rescue 5: 50 µs over 2 calls
    got = reader.read(fake_run("ozaki_host_ms", WINDOW))
    assert got == pytest.approx(50e-3 / 2)
    no_ozaki = [s for s in WINDOW if not s.name.startswith("ozaki.")]
    assert reader.read(fake_run("ozaki_host_ms", no_ozaki)) is None
    assert reader.read(fake_run("ozaki_host_ms", WINDOW, calls=0)) is None


def test_the_product_roofline_sums_bounds_by_recorded_shape():
    reader = harness.reader("mm_groups_f32pair_path_roofline")

    def bound(a):
        args = (a["slices"], a["m"], a["n"], a["k"])
        return max(mm_groups_f32pair.ops(*args) / INT8,
                   mm_groups_f32pair.nbytes(*args) / 3.35e12)

    # the launch without events counts neither its bound nor its time
    want = 100 * (bound(LEAF) + bound(CUBE)) / 2.01e-3
    assert reader.roofline(WINDOW, INT8, 3.35e12) == pytest.approx(want)
    assert reader.roofline(WINDOW[:6], INT8, 3.35e12) is None
    name = "mm_groups_f32pair_path_roofline"
    assert reader.read(fake_run(name, WINDOW, peaks=None)) is None
    assert reader.Probe.device == ("kernel.mm_groups_f32pair",)
    h100 = harness.read_json(harness.BENCH / "peaks_int8.json")
    assert h100["NVIDIA H100 80GB HBM3"]["int8_ops_per_s"] == INT8


def test_a_program_without_the_collector_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "collect")
    for name in ("ozaki_host_ms", "mm_groups_f32pair_path_roofline"):
        r = harness.reader(name)
        probe = r.Probe()
        with probe:
            probe.before_call()
            probe.after_call()
        assert r.read(fake_run(name, probe.spans)) is None


def small():
    """The cell at n = 96 with its own traffic and limits (the CPU takes
    the torch tiles in float64)."""
    cell = harness.resolve(CELL)
    cell.config.update({"n": 96})
    cell.mix.update({"sizes": [96]})
    return cell


def run(cell):
    return harness.run(cell, SEED, 0.2, False, device="cpu")


def test_a_sound_run_is_correct():
    cell = small()
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and set(r["checks"]) == set(cell.limits)


def test_the_float32_control_is_not_correct():
    cell = small()
    got = readings.reading(cell, SEED, "cpu", control=True, seconds=0.2)
    ok, checks = compare.judge({**got["control"], "failed_calls": 0.0},
                               cell.limits)
    assert not ok, checks
    assert checks["inv_err"]["value"] > 10 * cell.limits["inv_err"]
    assert compare.judge(got["program"], cell.limits)[0]


def test_an_altered_inverse_is_not_correct(monkeypatch):
    dpotri = ct.dpotri

    def altered(uplo, F, *args, **kwargs):
        inv, info = dpotri(uplo, F, *args, **kwargs)
        inv = inv.clone()
        inv[-1, 0] += 1e-2 * inv.abs().max()
        return inv, info

    monkeypatch.setattr(ct, "dpotri", altered)
    r = run(small())
    assert not r["correct"] and r["checks"]["factor_err"]["value"] < 1e-9
