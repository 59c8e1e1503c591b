"""Host ms per call in the blocked drivers: the self time of the
program's ``driver.*`` spans (each recursion's top-level call, less the
``kernel.*`` spans inside), summed over the window, over its calls
(``benchmark/spans.py``)."""

from benchmark import spans

Probe = spans.Probe


def read(run):
    got = spans.spans_of(run, "driver_host_ms")
    return None if got is None else spans.host_ms_per_call(
        got, "driver", run.window.calls)
