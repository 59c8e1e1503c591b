"""Host ms per call in the d tier: the self time of the program's
``ozaki.*`` spans (the peels' and products' torch passes and the refined
leaves, less the ``kernel.*`` spans inside), summed over the window, over
its calls (``benchmark/spans.py``). None where the window holds no such
span: a program older than these spans, or a cell off the d tier."""

from benchmark import spans

Probe = spans.Probe


def read(run):
    got = spans.spans_of(run, "ozaki_host_ms")
    if got is None or not run.window.calls:
        return None
    own = spans.self_ns(got)
    mine = [own[s.id] for s in got if s.name.startswith("ozaki.")]
    return sum(mine) / 1e6 / run.window.calls if mine else None
