"""The port's trace helpers (cholesky_tpu_torch/utils/profiling.py) held to
the contracts of tests/test_profiling.py: a trace writes an artifact,
annotate() is a no-op without an open trace, annotate_function keeps the
value. Beside them: the span's name reaches the Chrome trace, and
device_time, the census of a call's CUDA kernels, gives an empty census
on a machine without a card and raises, never under-counts, when the
profiler recorded more kernel launches than kernels."""

import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from cholesky_tpu_torch.utils import profiling
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401


def _files(logdir):
    return [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]


def test_trace_writes_artifact(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as where:
        with profiling.annotate("matmul-under-trace"):
            x = torch.ones((64, 64))
            torch.matmul(x, x)
    assert where == logdir
    found = _files(logdir)
    assert found, f"no trace artifacts written under {logdir}"
    assert all(f.endswith(".pt.trace.json") for f in found)


def test_annotate_is_standalone_noop():
    with profiling.annotate("no-active-trace"):
        x = torch.ones((8, 8))
        assert float((x * 2).sum()) == 128.0


def test_annotate_function_preserves_value():
    fn = profiling.annotate_function(lambda a: a + 1, name="inc")
    out = fn(torch.tensor(41.0))
    assert float(out) == 42.0


def test_trace_names_the_span(tmp_path):
    logdir = str(tmp_path / "trace")

    def step(x):
        return torch.matmul(x, x)

    traced = profiling.annotate_function(step)
    with profiling.trace(logdir):
        with profiling.annotate("sweep-potrf"):
            traced(torch.ones((32, 32)))
    (path,) = _files(logdir)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "sweep-potrf" in names
    assert step.__qualname__ in names      # annotate_function's default


def test_device_time_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    calls = []
    census = profiling.device_time(lambda: calls.append(1))
    assert census == {"busy": [0.0, 0]}
    assert calls == [1]


@pytest.mark.parametrize("raw,name", [
    ("void (anonymous namespace)::potf2_update128<true>(float*, long long)",
     "potf2_update128<true>"),
    ("ct::t128::gemm128_kernel(float const*, long long)", "gemm128_kernel"),
    ("potrf_stream_f32_kernel(float*, long long, float*)",
     "potrf_stream_f32_kernel"),
])
def test_kernel_name(raw, name):
    assert profiling.kernel_name(raw) == name


def _event(name, device, start=0.0, end=1.0):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("launches,device,lost", [
    ([], [], False),
    (["cudaLaunchKernel"], ["gemm128_kernel"], False),
    (["cudaLaunchKernel"], [], True),
    # a fill is no kernel: it does not stand in for a lost one
    (["cudaLaunchKernel", "cudaMemsetAsync"], ["Memset (Device)"], True),
    (["cudaLaunchCooperativeKernel", "cudaLaunchKernelExC", "cuLaunchKernel"],
     ["potrf_stream_f32_kernel", "trti2_leaf", "sm90_xmma_gemm"], False),
    (["cudaLaunchCooperativeKernel", "cudaLaunchKernelExC", "cuLaunchKernel"],
     ["potrf_stream_f32_kernel", "Memcpy DtoD (Device -> Device)",
      "trti2_leaf"], True),
    # kernels the profiler saw without their launch call (a graph replay)
    (["cudaGraphLaunch"], ["a", "b"], False),
])
def test_cuda_kernels_raises_on_lost_kernels(launches, device, lost):
    events = ([_event(x, DeviceType.CPU) for x in launches + ["aten::mm"]]
              + [_event(x, DeviceType.CUDA, 10.0 - i, 11.0)
                 for i, x in enumerate(device)])
    if lost:
        with pytest.raises(profiling.LostKernels):
            profiling.cuda_kernels(events)
    else:
        got = profiling.cuda_kernels(events)
        assert [x[0] for x in got] == device[::-1]   # in start order


@pytest.mark.parametrize("kept_guards,fn_kernels,lost", [
    (3, ["gemm128_kernel", "potrf_stream_f32_kernel"], False),
    (0, ["gemm128_kernel", "potrf_stream_f32_kernel"], False),
    (3, ["potrf_stream_f32_kernel"], True),
    (0, [], True),
])
def test_guard_kernels_absorb_the_loss(kept_guards, fn_kernels, lost):
    # three guards launched first, then two kernels of the call: lost
    # guards are no fault, a lost kernel of the call is; the guards are
    # left out of the census
    guard = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = ([_event("cudaLaunchKernel", DeviceType.CPU)] * 5
              + [_event(guard, DeviceType.CUDA, i, i + 1.0)
                 for i in range(kept_guards)]
              + [_event(x, DeviceType.CUDA, 10.0 + i, 11.0 + i)
                 for i, x in enumerate(fn_kernels)])
    if lost:
        with pytest.raises(profiling.LostKernels):
            profiling.cuda_kernels(events, guards=3)
    else:
        got = profiling.cuda_kernels(events, guards=3)
        assert [x[0] for x in got] == fn_kernels


class _FakeProfile:
    """torch.profiler.profile's shape, recording nothing."""

    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return []


@pytest.mark.parametrize("losses,ran", [
    (0, 1),        # the first window keeps its kernels
    (1, 2),        # one lost window: the call runs again behind more guards
    (3, 3),        # every attempt lost a kernel: LostKernels
])
def test_lost_window_runs_again_behind_more_guards(monkeypatch, losses,
                                                   ran):
    # a window that lost a kernel of the call runs the call again behind
    # the next entry's guard kernels; the census is that of the last run,
    # and the last attempt's loss raises
    guards, calls, sleeps = (2, 5, 9), [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda c: sleeps.append(c))
    monkeypatch.setattr(profiling, "profile", _FakeProfile)

    def census(events, n):
        assert n == guards[len(calls) - 1]
        if len(calls) <= losses:
            raise profiling.LostKernels(f"window {len(calls)}")
        return [("gemm128_kernel", 0.0, 1.0)]

    monkeypatch.setattr(profiling, "cuda_kernels", census)
    if losses == len(guards):
        with pytest.warns(UserWarning, match="runs again behind"):
            with pytest.raises(profiling.LostKernels, match="window 3"):
                profiling.kernel_events(lambda: calls.append(1), guards)
    elif losses:
        with pytest.warns(UserWarning, match="runs again behind 5"):
            _, got = profiling.kernel_events(lambda: calls.append(1), guards)
        assert got == [("gemm128_kernel", 0.0, 1.0)]
    else:
        _, got = profiling.kernel_events(lambda: calls.append(1), guards)
        assert got == [("gemm128_kernel", 0.0, 1.0)]
    assert len(calls) == ran
    assert len(sleeps) == sum(guards[:ran])
