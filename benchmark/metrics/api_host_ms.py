"""Host ms per call in the API and dispatch layer: the self time of the
program's ``api.*`` spans and of ``blocked.copy_in`` / ``copy_out``
inside them (their duration less the ``driver.*`` and ``kernel.*`` spans
inside), summed over the window, over its calls (``benchmark/spans.py``).
"""

from benchmark import spans

Probe = spans.Probe


def read(run):
    got = spans.spans_of(run, "api_host_ms")
    return None if got is None else spans.host_ms_per_call(
        got, "api", run.window.calls)
