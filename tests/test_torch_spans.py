"""The program's spans (cholesky_tpu_torch/utils/profiling.py) on the CPU:
nothing recorded and nothing created with no collector and no profiler;
under ``collect()`` one root per top-level call, the layers beneath it
sharing its call id, self times that add up to the root's duration, a
kernel wrapper's launch shape; nested collectors sharing one list; and
the same names in a ``torch.profiler`` trace, inside its window."""

import collections
import itertools
import json

import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu_torch.models import gp
from cholesky_tpu_torch.ops.kernels import gemm, mega, ozaki, prng, syrk, trmm
from cholesky_tpu_torch.utils import profiling
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401


def spd(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    G = torch.randn((n, n), generator=g)
    return G @ G.T / n + torch.eye(n)


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def self_ns(spans, s):
    return s.host_ns - sum(c.host_ns for c in children(spans, s))


def test_off_path_records_nothing_and_creates_no_event(monkeypatch):
    made = []

    def sentinel(*args, **kwargs):
        made.append(args)
        raise AssertionError("created with nothing recording")

    monkeypatch.setattr(profiling, "_range", sentinel)
    monkeypatch.setattr(torch.cuda, "Event", sentinel)
    assert profiling._open == 0 and not torch.autograd._profiler_enabled()
    F, info = ct.potrf("L", spd(64))
    gemm.gemm_f32(torch.ones((8, 4)), torch.ones((4, 8)))
    assert int(info) == 0 and made == []
    assert profiling.annotate("x") is profiling.annotate("y")
    assert profiling.launch_events() is profiling.annotate("z")


def test_potrf_is_one_root_over_its_layers():
    with profiling.collect() as spans:
        F, info = ct.potrf("L", spd(96))
    assert int(info) == 0
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "api.potrf"
    assert [c.name for c in children(spans, root)] == [
        "blocked.copy_in", "driver.potrf_lower", "blocked.copy_out"]
    assert {s.call for s in spans} == {root.id}
    assert root.attrs == {"shape": (96, 96), "dtype": "float32",
                          "pair": False, "backend": "torch"}
    selfs = [self_ns(spans, s) for s in spans]
    assert all(t >= 0 for t in selfs)
    assert sum(selfs) == root.host_ns
    assert all(s.end_ns > 0 and s.events is None for s in spans)


def hpd(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    G = torch.randn((n, n), dtype=dtype, generator=g)
    return G @ G.mH / n + torch.eye(n, dtype=dtype)


def planes(Z):
    return (Z.real.contiguous(), Z.imag.contiguous())


@pytest.mark.parametrize("operand,backend,route,attr", [
    (lambda: spd(16), "auto", "torch", "torch"),
    (lambda: spd(16).double(), "auto", "torch", "torch"),
    (lambda: hpd(16, torch.complex64), "auto", "torch", "torch"),
    (lambda: planes(hpd(16, torch.complex64)), "auto", "embed", "embed"),
    (lambda: planes(hpd(16, torch.complex128)), "auto", "embed", "embed"),
    (lambda: spd(16).double(), "ozaki", "ozaki", "ozaki"),
    (lambda: hpd(16, torch.complex64), "embed", "embed", "embed"),
    # an explicit backend is the span's attribute as the caller named it
    (lambda: planes(hpd(16, torch.complex64)), "torch", "embed", "torch"),
], ids=["f32", "f64", "c64", "pair-f32", "pair-f64", "f64-ozaki",
        "c64-embed", "pair-torch"])
def test_api_span_backend_names_the_route_the_call_takes(
        operand, backend, route, attr, monkeypatch):
    from cholesky_tpu_torch.ops import blocked

    taken = []
    tiles_for, embedding = blocked._tiles_for, blocked._embedding
    names = {blocked._TorchTiles: "torch", blocked._KernelTiles: "cuda",
             blocked._OzakiTiles: "ozaki"}

    def spy_tiles(*args, **kwargs):
        t = tiles_for(*args, **kwargs)
        taken.append(names[type(t)])
        return t

    def spy_embedding():
        taken.append("embed")
        return embedding()

    monkeypatch.setattr(blocked, "_tiles_for", spy_tiles)
    monkeypatch.setattr(blocked, "_embedding", spy_embedding)
    A = operand()
    assert blocked.route(A, backend) == route
    with profiling.collect() as spans:
        _, info = ct.potrf("L", A, backend=backend)
    assert int(info) == 0
    (root,) = [s for s in spans if s.parent is None]
    assert taken[0] == route
    assert root.attrs["backend"] == attr
    if backend == "auto":
        assert root.attrs["backend"] == taken[0]


def test_gp_train_step_is_one_root_with_five_api_calls():
    g = torch.Generator().manual_seed(1)
    X = torch.rand((256, 8), generator=g) * 2 - 1
    y = torch.sin(X.sum(dim=1))
    with profiling.collect() as spans:
        gp.gp_train_step(gp.GPParams.init(device="cpu"), X, y)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "gp.train_step"
    api = [c.name for c in children(spans, root) if c.name.startswith("api.")]
    assert api == ["api.potrf", "api.logdet_from_factor", "api.trsm",
                   "api.trsm", "api.potri"]
    names = {c.name for c in children(spans, root)}
    assert {"gp.kernel_matrix", "gp.gradient_passes"} <= names
    assert {s.call for s in spans} == {root.id}
    assert sum(self_ns(spans, s) for s in spans) == root.host_ns


def ancestors(spans, s):
    by = {x.id: x for x in spans}
    while s.parent is not None:
        s = by[s.parent]
        yield s


OZAKI_ATTRS = {"ozaki.split": {"m", "k", "slices"},
               "ozaki.product": {"m", "n", "k"},
               "ozaki.potf2": {"n"}, "ozaki.trti2": {"n"},
               "ozaki.lauu2": {"n"}}


def test_a_d_call_spans_its_ozaki_layer():
    A = spd(256).double()
    with profiling.collect() as spans:
        F, i1 = ct.dpotrf("L", A, backend="ozaki", block_size=64)
        inv, i2 = ct.dpotri("L", F, backend="ozaki", block_size=64)
    assert int(i1) == int(i2) == 0
    by = {s.id: s for s in spans}
    names = collections.Counter(s.name for s in spans)
    assert set(OZAKI_ATTRS) <= set(names) and "ozaki.rescue" not in names
    for s in spans:
        if s.name in OZAKI_ATTRS:
            assert set(s.attrs) == OZAKI_ATTRS[s.name], s
            assert any(a.name.startswith(("driver.", "api."))
                       for a in ancestors(spans, s))
        if s.name.startswith("kernel."):
            # the twins of the d tier's kernels and of its f32 leaves
            assert by[s.parent].name.startswith("ozaki."), s
    assert {by[s.parent].name for s in spans
            if s.name == "kernel.peel_f64"} == {"ozaki.split"}
    assert {by[s.parent].name for s in spans
            if s.name == "kernel.mm_groups_f64"} == {"ozaki.product"}
    assert sum(self_ns(spans, s) for s in spans) == sum(
        s.host_ns for s in spans if s.parent is None)


def test_the_rescue_pass_is_one_span():
    # PD in f64 but singular in f32 (tests/test_torch_dtier.py's
    # test_dpotrf_f64_rescue): the second pass runs, once
    a = 0.5
    A = torch.tensor([[1.0, a], [a, a * a + 1e-12]], dtype=torch.float64)
    with profiling.collect() as spans:
        F, info = ct.dpotrf("L", A, backend="ozaki")
    assert int(info) == 0
    (rescue,) = [s for s in spans if s.name == "ozaki.rescue"]
    by = {s.id: s for s in spans}
    assert by[rescue.parent].name == "api.potrf"
    assert [c.name for c in children(spans, rescue)] == [
        "blocked.copy_in", "driver.potrf_lower"]


@pytest.mark.parametrize("call, name, attrs", [
    (lambda: gemm.gemm_f32(torch.ones((6, 5)), torch.ones((5, 7))),
     "gemm_f32", {"m": 6, "n": 7, "k": 5, "dtype": "float32",
                  "c_read": False}),
    (lambda: gemm.gemm_f32(torch.ones((6, 5)), torch.ones((5, 7)),
                           torch.ones((6, 7)), beta=1.0),
     "gemm_f32", {"m": 6, "n": 7, "k": 5, "dtype": "float32",
                  "c_read": True}),
    (lambda: syrk.syrk_lower_f32(-1.0, torch.ones((9, 3)), 1.0,
                                 torch.eye(9)),
     "syrk_lower_f32", {"n": 9, "k": 3, "dtype": "float32", "c_read": True}),
    (lambda: mega.potrf_stream_f32(spd(256)),
     "potrf_stream_f32", {"n": 256, "dtype": "float32"}),
    (lambda: trmm.trmm_lln_f32(torch.eye(4), torch.ones((4, 3))),
     "trmm_lln_f32", {"n": 4, "m": 3, "dtype": "float32"}),
    (lambda: ozaki.peel_f32pair(torch.zeros((3, 5)), torch.zeros((3, 5)),
                                slices=2),
     "peel_f32pair", {"m": 3, "k": 5, "slices": 2}),
    (lambda: prng.uniform_fill_f32(torch.zeros((1,), dtype=torch.int32),
                                   4, 6),
     "uniform_fill_f32", {"m": 4, "n": 6}),
    (lambda: ozaki.peel_f64(torch.zeros((3, 5), dtype=torch.float64),
                            slices=2),
     "peel_f64", {"m": 3, "k": 5, "slices": 2}),
    (lambda: ozaki.mm_groups_f64(
        torch.zeros((2, 3, 5), dtype=torch.int8),
        torch.ones(3, dtype=torch.float64),
        torch.zeros((2, 4, 5), dtype=torch.int8),
        torch.ones(4, dtype=torch.float64),
        out=torch.zeros((3, 4), dtype=torch.float64), beta=1.0),
     "mm_groups_f64", {"slices": 2, "m": 3, "n": 4, "k": 5, "c_read": True}),
])
def test_a_kernel_wrapper_records_its_shape(call, name, attrs):
    with profiling.collect(device=True) as spans:
        call()
    (span,) = spans
    assert span.name == f"kernel.{name}" and span.parent is None
    assert span.attrs == attrs
    # the plain twin launches nothing: no device events
    assert span.events is None and span.device_ms() is None


def test_collectors_nest_and_share_one_list():
    with profiling.collect() as outer:
        with profiling.collect(device=True) as inner:
            ct.potrf("L", spd(32))
        assert inner is outer
        ct.trsm("L", "L", "N", "N", 1.0, torch.eye(4), torch.ones((4, 1)))
    assert [s.name for s in outer if s.parent is None] == ["api.potrf",
                                                           "api.trsm"]
    assert profiling._open == 0 and profiling._device == ()
    with profiling.collect() as fresh:
        pass
    assert fresh == [] and fresh is not outer


def test_a_span_that_raises_keeps_the_stack_and_no_attrs():
    with profiling.collect() as spans:
        with pytest.raises(Exception):
            ct.potrf("L", torch.ones((3, 4)))
        ct.potrf("L", spd(8))
    failed, ok = [s for s in spans if s.parent is None]
    assert failed.attrs is None and failed.end_ns > 0
    assert ok.name == "api.potrf" and ok.attrs["shape"] == (8, 8)


def test_trace_holds_the_program_spans_inside_its_window(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("window"):
            ct.potrf("L", spd(64))
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    (w,) = by["window"]
    for name in ("api.potrf", "blocked.copy_in", "driver.potrf_lower",
                 "blocked.copy_out"):
        (e,) = by[name]
        assert w["ts"] <= e["ts"] and e["ts"] + e["dur"] <= w["ts"] + w["dur"]
    assert profiling._open == 0


class FakeEvent:
    """A CUDA event's stand-in on the CPU: each record takes the next tick
    of a clock in ms; it has run once recorded, while ``ran`` holds."""
    clock = itertools.count()
    ran = True

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = float(next(FakeEvent.clock))

    def query(self):
        return self.t is not None and FakeEvent.ran

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentStream",
                        lambda dev: (7, dev, 1), raising=False)
    for name, fresh in (("_pool", []), ("_pending", collections.deque()),
                        ("_streams", {})):
        monkeypatch.setattr(profiling, name, fresh)
    monkeypatch.setattr(profiling, "POOL_EVENTS", 8)
    monkeypatch.setattr(FakeEvent, "ran", True)


def test_device_pairs_only_where_asked_and_back_to_the_pool(fake_card):
    def launch():
        with profiling.launch_events():
            pass

    kernel = profiling.annotate_function(launch, "kernel.k", launch=True)
    other = profiling.annotate_function(launch, "kernel.other", launch=True)

    def call():
        with profiling.annotate("api.call"):
            with profiling.annotate("blocked.copy_in"):
                pass
            kernel()
            other()

    with profiling.collect(device=("api.", "kernel.k")) as spans:
        assert len(profiling._pool) == 8
        FakeEvent.ran = False       # the card has not reached them
        call()
        # a pair for api.call and one for kernel.k, in end order
        assert [s.name for s in profiling._pending] == ["kernel.k",
                                                        "api.call"]
        assert len(profiling._pool) == 4
        FakeEvent.ran = True
        call()      # its root's end reads every pair that has run
        assert not profiling._pending and len(profiling._pool) == 8
    assert profiling._device == ()
    timed = {s.name: s.device_ms() for s in spans}
    assert timed["blocked.copy_in"] is None and timed["kernel.other"] is None
    # the kernel's pair brackets its launch alone: one tick apart
    assert [s.device_ms() for s in spans if s.name == "kernel.k"] == [1.0,
                                                                      1.0]
    assert all(s.device_ms() > 1.0 for s in spans if s.name == "api.call")
