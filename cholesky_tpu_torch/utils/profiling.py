"""Tracing and profiling helpers: the counterpart of
``cholesky_tpu/utils/profiling.py``.

``trace`` records a block under ``torch.profiler`` with the library's
timing discipline applied (the card's queue drained before the trace
window closes) and writes a Chrome trace; ``annotate`` and
``annotate_function`` put named spans into it (and NVTX ranges where a
card is present). ``device_time`` is the census of the CUDA kernels one
call runs: device time and launches by kernel name, and the busy time of
the device as the union of their intervals. On some H100 machines
torch.profiler loses the first device records of a window, more of them
the longer the process has run: a census window opens with guard
kernels that absorb the loss, a window in which the profiler still
recorded more kernel launches than kernels runs again behind more
guards, and the last such attempt raises ``LostKernels``, so that no
census reads a lost window as an idle device.

The reference keeps its timing in its test binaries (CUevent loops,
test/lapack/cuspotrf.c:129-141); per-kernel latency belongs to
``benchlib.bench_op`` (CUDA events) and a trace shows the structure, what
overlaps what.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import socket
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


def _activities() -> list:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _drain() -> None:
    """Wait for the work queued on the card, so that it lands inside the
    trace window (the counterpart of ``jax.effects_barrier``)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the enclosed block (CPU, plus
    CUDA where a card is present) and write it as a Chrome trace
    (``*.pt.trace.json``) under ``logdir``; yields ``logdir``.

    The card's queue is drained at block exit, before the profiler stops:
    kernels launched inside the block run after their launch returns and
    would otherwise fall outside the window.

    Usage::

        with profiling.trace("traces/potrf"):
            with profiling.annotate("potrf-4096"):
                F, info = ct.potrf("L", A)
    """
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=_activities())
    try:
        with prof:
            try:
                yield logdir
            finally:
                _drain()
    finally:
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"{name}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named span: a ``record_function`` range in any open trace, plus an
    NVTX range where a card is present (a CPU-only build of torch raises
    on NVTX calls). Costs no more than a function call without a trace."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate_function(fn, name: str | None = None):
    """``fn`` wrapped so that every call is a span named ``name`` (default:
    ``fn``'s qualified name); returns ``fn``'s value."""
    label = name or getattr(fn, "__qualname__", repr(fn))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with annotate(label):
            return fn(*args, **kwargs)

    return wrapped


def kernel_name(name: str) -> str:
    """A CUDA kernel's name as the profiler shows it, without its return
    type, namespaces and parameters (``potf2_update128<true>``)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].rsplit("::", 1)[-1]


def busy_ms(intervals) -> float:
    """The union of (start, end) µs intervals, in ms: kernels that overlap
    (a launch scheduled early by programmatic dependent launch waits
    inside its predecessor's run) count once."""
    total, last = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > last:
            total += b - max(a, last)
            last = b
    return total / 1e3


class LostKernels(RuntimeError):
    """The profiler recorded a window's kernel launches but not all of
    their kernels: a census of that window would count too little."""


#: kernels launched at the start of a census window, before ``fn``, one
#: entry for each attempt. On some H100 machines torch.profiler loses the
#: first device records of a window, more of them the longer the process
#: has run the port's kernels; the guards absorb that loss and are left
#: out of the census, and a window that lost a kernel of ``fn`` all the
#: same runs again behind the next entry's guards.
GUARD_LAUNCHES = (128, 1024, 8192)
GUARD_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel


def _is_launch(name: str) -> bool:
    """A runtime or driver call that launches one kernel
    (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
    ``cudaLaunchCooperativeKernel``, ``cuLaunchKernel``,
    ``cuLaunchKernelEx``)."""
    return name.startswith("cu") and "Launch" in name and "Kernel" in name


def cuda_kernels(events, guards: int = 0) -> list:
    """[(name, start µs, end µs)] of the device's events among the
    profiler's ``events`` (kernels, and the copies and fills that no
    kernel launch made) in start order, without the ``guards`` guard
    kernels launched first. Raises :class:`LostKernels` when the other
    launches outnumber the other kernels: every launch runs one kernel,
    so the profiler lost some."""
    device, launches, kept = [], 0, 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if GUARD_KERNEL in e.name:
                kept += 1
            else:
                device.append((e.name, e.time_range.start, e.time_range.end))
        elif _is_launch(e.name):
            launches += 1
    kernels = sum(not name.startswith(("Memcpy", "Memset"))
                  for name, _, _ in device)
    if kernels < launches - guards:
        raise LostKernels(f"torch.profiler recorded {launches - guards} "
                          f"kernel launches and {kernels} CUDA kernels "
                          f"({kept} of {guards} guard kernels)")
    return sorted(device, key=lambda e: e[1])


def kernel_events(fn, guards=GUARD_LAUNCHES) -> tuple[float, list]:
    """Run ``fn()`` under ``torch.profiler``, the card idle before and
    drained after: (wall ms of the call and the drain, [(kernel name as
    the profiler gives it, start µs, end µs)] of the CUDA kernels it ran,
    in start order). On a card the window opens with ``guards[0]`` guard
    kernels; a window whose kernels the profiler lost runs ``fn`` again
    behind ``guards[1]``, and so on, so ``fn`` may run once for each
    entry and the census is that of its last run. Raises
    :class:`LostKernels` rather than return a census short of a launched
    kernel."""
    attempts = list(guards) if torch.cuda.is_available() else [0]
    while True:
        n = attempts.pop(0)
        _drain()
        with profile(activities=_activities()) as prof:
            for _ in range(n):
                torch.cuda._sleep(1)
            _drain()
            t0 = time.perf_counter()
            fn()
            _drain()
            wall = (time.perf_counter() - t0) * 1e3
        try:
            return wall, cuda_kernels(prof.events(), n)
        except LostKernels as lost:
            if not attempts:
                raise
            warnings.warn(f"{lost} behind {n} guard kernels; the window "
                          f"runs again behind {attempts[0]}")


def device_time(fn, match: str = "", guards=GUARD_LAUNCHES) -> dict:
    """``fn()`` under ``torch.profiler``: {kernel: [device ms, launches]}
    for the CUDA kernels whose name holds ``match`` (named by
    :func:`kernel_name`), and under "busy" [the union of their intervals
    in ms, their count]. Without a card it is {"busy": [0.0, 0]}. ``fn``
    may run once for each entry of ``guards`` (see :func:`kernel_events`);
    a window whose kernels the profiler lost at every attempt raises
    :class:`LostKernels`."""
    _, events = kernel_events(fn, guards)
    split, spans = {}, []
    for name, a, b in events:
        if match in name:
            row = split.setdefault(kernel_name(name), [0.0, 0])
            row[0] += (b - a) / 1e3
            row[1] += 1
            spans.append((a, b))
    split["busy"] = [busy_ms(spans), len(spans)]
    return split
