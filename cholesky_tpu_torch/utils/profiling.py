"""Tracing and profiling helpers: the counterpart of
``cholesky_tpu/utils/profiling.py``.

``trace`` records a block under ``torch.profiler`` with the library's
timing discipline applied (the card's queue drained before the trace
window closes) and writes a Chrome trace. ``annotate`` and
``annotate_function`` are the program's spans, one at each layer
boundary (``gp.*``, ``api.*``, ``blocked.*``, ``driver.*``,
``kernel.*``): while torch.profiler runs each is one of its ranges, on
the clock of the card's records; while ``collect`` is open each
is kept in memory with its parent, its call, its host interval, its
attributes and, on request, a pair of CUDA events. With neither, a span
costs two flag checks. ``device_time`` is the census of the CUDA kernels
one call runs: device time and launches by kernel name, and the busy
time of the device as the union of their intervals. On some H100
machines torch.profiler loses the first device records of a window, more
of them the longer the process has run: a census window opens with
guard kernels that absorb the loss, a window in which the profiler still
recorded more kernel launches than kernels runs again behind more
guards, and the last such attempt raises ``LostKernels``, so that no
census reads a lost window as an idle device.

The reference keeps its timing in its test binaries (CUevent loops,
test/lapack/cuspotrf.c:129-141); per-kernel latency belongs to
``benchlib.bench_op`` (CUDA events) and a trace shows the structure, what
overlaps what.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import math
import os
import socket
import threading
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


# ---------------------------------------------------------------------------
# Spans: the program's layer boundaries (models/gp.py, ops/dispatch.py,
# ops/blocked.py, each kernel wrapper). A span does nothing but check two
# flags unless a collector is open or torch.profiler is running.
# ---------------------------------------------------------------------------

#: torch's own test for a running profiler (a C call, tens of ns): a trace
#: or a census sets no flag of this module
_profiler_enabled = torch.autograd._profiler_enabled
#: a span's range while a profiler runs: torch's range written in C++
#: where this torch has it (a few µs a span under the profiler against
#: record_function's 15, which would widen the idle gaps it names), else
#: record_function
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or record_function
#: open collectors; the names whose spans record CUDA events (prefixes,
#: the union of what the open collectors asked for: () for none, ("",)
#: for all), and each open collector's request
_open = 0
_device: tuple = ()
_asked: list = []
_spans: list = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
#: CUDA events made before a window, reused once read: on the H100's host
#: making and recording one costs about 18 µs, recording a made one on a
#: given stream about 3.4
_pool: list = []
#: spans whose event pairs are recorded and not yet read, in end order
_pending: collections.deque = collections.deque()
#: events made when a device collector opens
POOL_EVENTS = 4096
#: Stream objects by (device, stream id): torch.cuda.current_stream()
#: builds one a call, about 8 µs on the H100's host
_streams: dict = {}


class _Null:
    """The shared context of a span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


_NULL = _Null()


@dataclasses.dataclass(slots=True)
class Span:
    """One span kept by :func:`collect`: its name, its id, its parent's id
    (None for a root), the root's id (``call``, shared by every span of one
    top-level call), host start and end (``time.perf_counter_ns``), the
    attributes of the call (shape, dtype, backend), and, under
    ``collect(device=True)``, the device ms between a pair of CUDA events
    (a kernel span's pair brackets its launch alone). ``end_ns`` is 0
    while it runs."""
    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int = 0
    end_ns: int = 0
    attrs: dict | None = None
    events: list | None = None      # [start, end] until read
    ms: float | None = None

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    def device_ms(self) -> float | None:
        """Device-stream ms between the span's events, once they have run
        (synchronize first); None without them."""
        if self.ms is None and self.events is not None \
                and self.events[1] is not None:
            self.ms = self.events[0].elapsed_time(self.events[1])
        return self.ms


def _stack() -> list:
    s = getattr(_local, "open", None)
    if s is None:
        s = _local.open = []
    return s


def _event():
    """A CUDA event recorded on the current stream, from the pool."""
    e = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    dev = torch._C._cuda_getDevice()
    key = (dev, torch._C._cuda_getCurrentStream(dev)[0])
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(dev)
    e.record(stream)
    return e


def _close(rec):
    rec.events[1] = _event()
    _pending.append(rec)


def _settle():
    """Read the pairs that have run, oldest first, and give their events
    back to the pool; stop at the first pair still queued."""
    with _lock:
        while _pending:
            rec = _pending[0]
            start, end = rec.events
            if not end.query():
                return
            rec.ms = start.elapsed_time(end)
            rec.events = None
            _pool.extend((start, end))
            _pending.popleft()


class _Active:
    """A span while a collector is open or the profiler runs: a range
    under the profiler (on the clock of its device records), a
    :class:`Span` under a collector."""
    __slots__ = ("name", "launch", "rf", "rec")

    def __init__(self, name, launch=False):
        self.name, self.launch, self.rf, self.rec = name, launch, None, None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = _range(self.name)
            self.rf.__enter__()
        if _open:
            stack = _stack()
            up = stack[-1] if stack else None
            sid = next(_ids)
            rec = (Span(self.name, sid, up.id, up.call) if up else
                   Span(self.name, sid, None, sid))
            if _device and not self.launch and \
                    self.name.startswith(_device):
                rec.events = [_event(), None]
            stack.append(rec)
            _spans.append(rec)
            self.rec = rec
            rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec.end_ns = time.perf_counter_ns()
            if rec.events is not None and rec.events[1] is None:
                _close(rec)
            stack = _stack()
            stack.pop()
            if not stack and _pending:
                # the earlier calls' pairs, read while the card runs this
                # call's work rather than between calls, when it idles
                _settle()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def annotate(name: str):
    """A named span over a ``with`` block: a range of torch.profiler's while
    it runs, a :class:`Span` while a collector is open. With neither, a
    shared null context after two flag checks."""
    if _open:
        return _Active(name)
    return _range(name) if _profiler_enabled() else _NULL


def annotate_function(fn=None, name: str | None = None, *, attrs=None,
                      launch: bool = False):
    """``fn`` wrapped so that every call is a span named ``name`` (default:
    ``fn``'s qualified name); returns ``fn``'s value. Without ``fn``, the
    decorator. ``attrs(*args, **kwargs)`` gives the span's attributes
    under a collector, read once ``fn`` has returned (never when it
    raised). ``launch``: the span is a kernel wrapper's, whose device
    events bracket its launch (:func:`launch_events`) and not the call.
    With no collector and no profiler the call goes straight through."""
    if fn is None:
        return functools.partial(annotate_function, name=name, attrs=attrs,
                                 launch=launch)
    label = name or getattr(fn, "__qualname__", repr(fn))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _open:
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _range(label):
                return fn(*args, **kwargs)
        span = _Active(label, launch)
        with span:
            out = fn(*args, **kwargs)
        if attrs is not None and span.rec is not None:
            span.rec.attrs = attrs(*args, **kwargs)
        return out

    return wrapped


class _Launch:
    __slots__ = ("rec",)

    def __enter__(self):
        stack = _stack()
        # a kernel span's pair is unset until its launch
        rec = stack[-1] if stack else None
        if rec is not None and rec.events is None \
                and rec.name.startswith(_device):
            rec.events = [_event(), None]
            self.rec = rec
        else:
            self.rec = None

    def __exit__(self, *exc):
        if self.rec is not None:
            _close(self.rec)
        return False


def launch_events():
    """Around a kernel wrapper's launch, after its checks and plan: under a
    device collector the innermost span's CUDA events are recorded
    right before and after the block, so that its device time is the
    launch's and not the Python before it; otherwise a null context."""
    return _Launch() if _device else _NULL


@contextlib.contextmanager
def collect(device=False):
    """Keep every span that starts inside the block, in start order (a
    parent before its children): yields the list of :class:`Span`.
    Collectors nest and share one list until the last one closes.
    ``device``: True, or the prefixes of the span names that also record
    a pair of CUDA events where a card is (``("kernel.gemm_f32",)``;
    fewer pairs queue less on the card). The events come from a pool of
    ``POOL_EVENTS`` made on entry; pairs are read at the end of each
    top-level call once the card has run them, the rest once the block has
    ended and the card synchronized (``Span.device_ms``).

    Usage::

        with profiling.collect(device=True) as spans:
            F, info = ct.potrf("L", A)
        torch.cuda.synchronize()
        for s in spans:
            print(s.name, s.parent, s.host_ns / 1e3, s.device_ms(), s.attrs)
    """
    global _open, _device, _spans
    want = () if not device or not torch.cuda.is_available() else \
        ("",) if device is True else tuple(device)
    with _lock:
        if _open == 0:
            _spans = []
        spans = _spans
        if want and len(_pool) < POOL_EVENTS:
            _pool.extend(torch.cuda.Event(enable_timing=True)
                         for _ in range(POOL_EVENTS - len(_pool)))
            for e in _pool:
                e.record()          # made now, not inside the window
        _open += 1
        _asked.append(want)
        _device = tuple(sorted({p for w in _asked for p in w}))
    try:
        yield spans
    finally:
        with _lock:
            _open -= 1
            _asked.remove(want)
            _device = tuple(sorted({p for w in _asked for p in w}))
            if not _device:
                _pending.clear()


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
            # a host range mirrored on the card's timeline is no kernel
            if getattr(e, "is_user_annotation", False):
                continue
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
