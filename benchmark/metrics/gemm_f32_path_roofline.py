"""gemm_f32 in the path: every launch of the window, each at the shape
its span recorded, as a share of its roofline (``counts/gemm_f32.py``,
``peaks.json``): the sum of the launches' bounds over the sum of their
CUDA-event times, each pair recorded right around the launch
(``benchmark/spans.py``)."""

from benchmark import spans
from benchmark.counts import gemm_f32 as counts

class Probe(spans.Probe):
    device = ("kernel.gemm_f32",)


def read(run):
    got = spans.spans_of(run, "gemm_f32_path_roofline")
    if got is None:
        return None
    return spans.path_roofline(
        got, "gemm_f32", lambda a: counts.ops(a["m"], a["n"], a["k"]),
        lambda a: counts.nbytes(a["m"], a["n"], a["k"], a["c_read"]),
        run.peaks)
