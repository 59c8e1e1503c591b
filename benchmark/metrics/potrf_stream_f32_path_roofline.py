"""potrf_stream_f32 in the path: every launch of the window at the n its
span recorded, as a share of its roofline
(``counts/potrf_stream_f32.py``, ``peaks.json``): the sum of the
launches' bounds over the sum of their CUDA-event times, each pair
recorded right around the launch (``benchmark/spans.py``). The
cross-check of ``potrf_stream_f32_roofline``, the kernel alone at n."""

from benchmark import spans
from benchmark.counts import potrf_stream_f32 as counts

class Probe(spans.Probe):
    device = ("kernel.potrf_stream_f32",)


def read(run):
    got = spans.spans_of(run, "potrf_stream_f32_path_roofline")
    if got is None:
        return None
    return spans.path_roofline(
        got, "potrf_stream_f32", lambda a: counts.ops(a["n"]),
        lambda a: counts.nbytes(a["n"]), run.peaks)
