"""Host ms per call inside the kernel wrappers: the duration of the
program's ``kernel.*`` spans (checks, plan, allocation of the launch's
buffers and the ctypes launch), summed over the window, over its calls
(``benchmark/spans.py``)."""

from benchmark import spans

Probe = spans.Probe


def read(run):
    got = spans.spans_of(run, "launch_host_ms")
    return None if got is None else spans.host_ms_per_call(
        got, "launch", run.window.calls)
