"""The reader of mm_groups_f64_path_roofline, the d tier's one-launch
product as a share of its roofline: its count, made-up spans, a window
without the kernel (a program older than it), and a program without the
collector."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.counts import mm_groups_f32pair, mm_groups_f64
from cholesky_tpu_torch.utils import profiling

NAME = "mm_groups_f64_path_roofline"
INT8 = 1979e12
HBM = 3.35e12


class Event:
    """A CUDA event's stand-in: recorded at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def span(sid, name, parent, attrs=None, device=None):
    return profiling.Span(
        name, sid, parent, 1, sid * 1000, sid * 1000 + 500, attrs,
        None if device is None else [Event(device[0]), Event(device[1])])


LEAF = {"slices": 6, "m": 128, "n": 128, "k": 128, "c_read": False}
CUBE = {"slices": 6, "m": 4096, "n": 4096, "k": 4096, "c_read": True}
WINDOW = [
    span(1, "ozaki.product", None, {"m": 128, "n": 128, "k": 128}),
    span(2, "kernel.mm_groups_f64", 1, LEAF, (0.0, 0.01)),
    span(3, "ozaki.product", None, {"m": 4096, "n": 4096, "k": 4096}),
    span(4, "kernel.mm_groups_f64", 3, CUBE, (1.0, 3.0)),
    span(5, "kernel.mm_groups_f64", 3, CUBE),           # no events
    span(6, "kernel.mm_groups_f32pair", None, CUBE, (4.0, 9.0)),
]


def fake_run(got, peaks={"f32_flops_per_s": 67e12, "hbm_bytes_per_s": HBM}):
    return SimpleNamespace(probes={NAME: SimpleNamespace(spans=got)},
                           window=SimpleNamespace(calls=2), peaks=peaks)


def test_the_count_adds_the_f64_epilogue_to_the_int8_work():
    args = (6, 4096, 4096, 4096)
    assert mm_groups_f64.ops(*args) == mm_groups_f32pair.ops(*args)
    assert mm_groups_f64.nbytes(*args, False) == (
        6 * 8192 * 4096 + 8 * 8192 + 8 * 4096 ** 2)
    assert mm_groups_f64.nbytes(*args, True) == (
        mm_groups_f64.nbytes(*args, False) + 8 * 4096 ** 2)
    # operations bound at 4096³: the bytes take under a tenth of the time
    assert mm_groups_f64.nbytes(*args, True) / HBM < (
        0.1 * mm_groups_f64.ops(*args) / INT8)


def test_the_roofline_sums_bounds_by_recorded_shape_and_update():
    reader = harness.reader(NAME)

    def bound(a):
        args = (a["slices"], a["m"], a["n"], a["k"])
        return max(mm_groups_f64.ops(*args) / INT8,
                   mm_groups_f64.nbytes(*args, a["c_read"]) / HBM)

    # the launch without events counts neither its bound nor its time, and
    # the pair kernel's launch is not this metric's
    want = 100 * (bound(LEAF) + bound(CUBE)) / 2.01e-3
    assert reader.roofline(WINDOW, INT8, HBM) == pytest.approx(want)
    assert reader.Probe.device == ("kernel.mm_groups_f64",)
    assert reader.read(fake_run(WINDOW, peaks=None)) is None


def test_a_window_without_the_kernel_reads_none():
    # the program before the one-launch product ran mm_groups_f32pair
    reader = harness.reader(NAME)
    older = [s for s in WINDOW if s.name != "kernel.mm_groups_f64"]
    assert reader.roofline(older, INT8, HBM) is None


def test_a_program_without_the_collector_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "collect")
    r = harness.reader(NAME)
    probe = r.Probe()
    with probe:
        probe.before_call()
        probe.after_call()
    assert r.read(fake_run(probe.spans)) is None
