"""The device census of a short window under ``torch.profiler``: busy time
as the union of the device's intervals, the idle share, the operations
that took most time, and the longest idle gaps by what the host was
doing. Kept in memory; nothing is written.

On some H100 machines torch.profiler loses the first device records of a
window, more of them the older the process. So the window opens with
guard kernels that absorb the loss, a window whose launches outnumber
its kernels runs again behind more guards, and after the last attempt
the census is given up (``None``): an idle share is never read from a
window that lost kernels. The method is that of the program's
``utils/profiling.py`` (``kernel_events``), copied so that the yardstick
does not move with the program.
"""

import bisect
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

GUARD_LAUNCHES = (128, 1024, 8192)
GUARD_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel
WINDOW = "benchmark.window"
CALL = "benchmark.call"
#: how an idle gap is named where no host operation but the benchmark's
#: own span of the call, or none, was running
UNNAMED = {CALL: "host python inside the call",
           None: "host python between calls"}
TOP = 10


def _is_launch(name):
    return name.startswith("cu") and "Launch" in name and "Kernel" in name


def _short(name):
    """A kernel's name without return type, namespaces and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].rsplit("::", 1)[-1]


def _union(intervals):
    """[(start, end)] merged, in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _running(host, starts, t):
    """The name of the host operation running at t that started last (the
    innermost)."""
    for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, _, end = host[k]
        if end >= t:
            return UNNAMED.get(name, name)
    return UNNAMED[None]


def _read(events, guards):
    """The census of one profiled window, or None where the profiler lost
    kernels of it."""
    device, host, launches, window = [], [], 0, None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # record_function's spans are mirrored on the device's
            # timeline: they are no device operation
            if not (GUARD_KERNEL in e.name or e.name in (WINDOW, CALL)
                    or getattr(e, "is_user_annotation", False)):
                device.append((e.name, a, b))
        elif e.name == WINDOW:
            window = (a, b)
        else:
            launches += _is_launch(e.name)
            host.append((e.name, a, b))
    kernels = sum(not n.startswith(("Memcpy", "Memset")) for n, _, _ in device)
    if window is None or kernels < launches - guards:
        return None
    w0, w1 = window
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    busy = _union((a, b) for _, a, b in inside)
    by_op = defaultdict(float)
    for n, a, b in inside:
        by_op[_short(n)] += (b - a) / 1e6
    # the idle gaps inside the window, each named by the innermost host
    # operation running at its middle
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host.sort(key=lambda h: h[1])
    starts = [ha for _, ha, _ in host]
    by_host = defaultdict(float)
    for a, b in gaps:
        by_host[_running(host, starts, (a + b) / 2)] += (b - a) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6

    def top(d):
        return sorted(([k, v] for k, v in d.items()),
                      key=lambda kv: -kv[1])[:TOP]

    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "device_ops": top(by_op), "idle_gaps": top(by_host)}


def measure(fn, guards=GUARD_LAUNCHES):
    """``fn()`` under torch.profiler behind guard kernels: {busy_s,
    window_s, device_ops, idle_gaps}, or None where every attempt lost
    kernels. ``fn`` runs once for each attempt."""
    for n in guards:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            with record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        got = _read(prof.events(), n)
        if got is not None:
            return got
    return None
