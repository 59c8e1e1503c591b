"""The span metrics' readers (``spans.py``, ``metrics/*_host_ms.py``,
``model_device_ms.py``, ``*_path_roofline.py``) on made-up span lists:
self times, per-call means, the model's device time outside the library
and the roofline summed by recorded shape; their probes on the program's
collector, and on a program without one."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.counts import gemm_f32, potrf_stream_f32
from cholesky_tpu_torch.utils import profiling

PEAKS = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


class Event:
    """A CUDA event's stand-in: recorded at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def span(sid, name, parent, call, start, end, attrs=None, device=None):
    """A kept span, host times in µs, device times (start, end) in ms."""
    return profiling.Span(
        name, sid, parent, call, start * 1000, end * 1000, attrs,
        None if device is None else [Event(device[0]), Event(device[1])])


def train_call(base, dev):
    """One GP call: the root, a kernel matrix, potrf (copy in, driver, one
    launch, copy out) and logdet; host µs from ``base``, device ms from
    ``dev``."""
    r = base
    return [
        span(r + 1, "gp.train_step", None, r + 1, base, base + 100,
             device=(dev, dev + 40)),
        span(r + 2, "gp.kernel_matrix", r + 1, r + 1, base + 2, base + 12,
             device=(dev, dev + 5)),
        span(r + 3, "api.potrf", r + 1, r + 1, base + 15, base + 75,
             device=(dev + 5, dev + 30)),
        span(r + 4, "blocked.copy_in", r + 3, r + 1, base + 16, base + 26),
        span(r + 5, "driver.potrf_lower", r + 3, r + 1, base + 30,
             base + 60),
        span(r + 6, "kernel.potrf_stream_f32", r + 5, r + 1, base + 35,
             base + 55, {"n": 8192, "dtype": "float32"},
             device=(dev + 6, dev + 28)),
        span(r + 7, "blocked.copy_out", r + 3, r + 1, base + 62, base + 70),
        span(r + 8, "api.logdet_from_factor", r + 1, r + 1, base + 80,
             base + 90, device=(dev + 31, dev + 33)),
    ]


WINDOW = train_call(0, 0.0) + train_call(1000, 50.0)


def test_self_times_add_up_to_the_roots():
    own = spans.self_ns(WINDOW)
    assert all(v >= 0 for v in own.values())
    assert own[3] == (60 - 10 - 30 - 8) * 1000     # api.potrf
    assert own[5] == (30 - 20) * 1000              # driver, less its launch
    assert sum(own.values()) == 2 * 100 * 1000


@pytest.mark.parametrize("layer, ms", [
    # per call: api (12 + 10 + 8 + 10), driver 10, launch 20, model
    # (100 - 10 - 60 - 10) + 10
    ("api", 0.040), ("driver", 0.010), ("launch", 0.020), ("model", 0.030),
])
def test_host_ms_per_call_by_layer(layer, ms):
    assert spans.host_ms_per_call(WINDOW, layer, 2) == pytest.approx(ms)


def test_a_layer_without_spans_reads_none():
    assert spans.host_ms_per_call(WINDOW[3:7], "model", 2) is None
    assert spans.host_ms_per_call(WINDOW, "api", 0) is None


def test_model_device_ms_is_the_root_less_its_api_calls():
    # 40 - 25 (potrf) - 2 (logdet) in each call
    assert spans.model_device_ms(WINDOW) == pytest.approx(13.0)
    assert spans.model_device_ms(WINDOW[2:8]) is None     # no gp root


def test_path_roofline_sums_bounds_by_recorded_shape():
    def ops(a):
        return gemm_f32.ops(a["m"], a["n"], a["k"])

    def nbytes(a):
        return gemm_f32.nbytes(a["m"], a["n"], a["k"], a["c_read"])

    thin = {"m": 8192, "n": 1, "k": 4096, "dtype": "float32",
            "c_read": True}
    cube = {"m": 4096, "n": 4096, "k": 4096, "dtype": "float32",
            "c_read": False}
    window = [span(1, "kernel.gemm_f32", None, 1, 0, 1, thin, (0.0, 0.1)),
              span(2, "kernel.gemm_f32", None, 2, 2, 3, cube, (1.0, 5.0)),
              span(3, "kernel.gemm_f32", None, 3, 4, 5, cube),   # no events
              span(4, "kernel.syrk_lower_f32", None, 4, 6, 7,
                   {"n": 64, "k": 64, "c_read": True}, (5.0, 9.0))]
    thin_s = 4 * (8192 * 4096 + 4096 + 2 * 8192) / 3.35e12   # bytes bound
    cube_s = 2 * 4096 ** 3 / 67e12                           # ops bound
    assert spans.path_roofline(window, "gemm_f32", ops, nbytes, PEAKS) == \
        pytest.approx(100 * (thin_s + cube_s) / 4.1e-3)
    assert spans.path_roofline(window, "trmm_lln_f32", ops, nbytes,
                               PEAKS) is None
    assert spans.path_roofline(window, "gemm_f32", ops, nbytes, None) is None


def test_the_potrf_reader_counts_its_kernel():
    reader = harness.reader("potrf_stream_f32_path_roofline")
    probe = SimpleNamespace(spans=WINDOW)
    run = SimpleNamespace(probes={"potrf_stream_f32_path_roofline": probe},
                          peaks=PEAKS)
    bound = potrf_stream_f32.ops(8192) / 67e12
    assert reader.read(run) == pytest.approx(100 * 2 * bound / 44e-3)


def fake_run(probes, calls=1):
    return SimpleNamespace(probes=probes, window=SimpleNamespace(calls=calls),
                           peaks=PEAKS)


def test_probes_read_the_program_collector():
    import cholesky_tpu_torch as ct

    names = ["api_host_ms", "driver_host_ms", "launch_host_ms",
             "model_device_ms"]
    readers = {n: harness.reader(n) for n in names}
    probes = {n: r.Probe() for n, r in readers.items()}
    A = torch.eye(64) * 4.0
    with probes["api_host_ms"], probes["driver_host_ms"], \
            probes["launch_host_ms"], probes["model_device_ms"]:
        for p in probes.values():
            p.before_call()
        ct.potrf("L", A)
        for p in probes.values():
            p.after_call()
    got = {n: r.read(fake_run(probes)) for n, r in readers.items()}
    # the CPU path launches no kernel, and a potrf call has no gp root
    assert got["api_host_ms"] > 0 and got["driver_host_ms"] > 0
    assert got["launch_host_ms"] is None and got["model_device_ms"] is None
    assert probes["api_host_ms"].spans is probes["model_device_ms"].spans


def test_a_program_without_the_collector_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "collect")
    for name in ("api_host_ms", "model_device_ms", "gemm_f32_path_roofline"):
        r = harness.reader(name)
        probe = r.Probe()
        with probe:
            probe.before_call()
            probe.after_call()
        assert r.read(fake_run({name: probe})) is None


def test_gp_outside_api_ms_wraps_the_same_entry_points():
    probe = harness.reader("gp_outside_api_ms").Probe()
    assert sorted(probe.names) == sorted([
        "gemm", "syrk", "herk", "trmm", "trmm2", "trsm", "potrf", "potf2",
        "trtri", "trtri2", "trti2", "lauum", "lauu2", "potri", "logdet",
        "logdet_from_factor"])
