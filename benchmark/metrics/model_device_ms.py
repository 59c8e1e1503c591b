"""Device-stream ms per GP call outside the library: the CUDA-event span
of each root ``gp.*`` span less those of its outermost ``api.*`` spans
(kernel matrices, torch's elementwise passes and reductions, and the
host's gaps between them), averaged over the window's roots. The
program's own twin of ``gp_outside_api_ms`` (``benchmark/spans.py``)."""

from benchmark import spans

class Probe(spans.Probe):
    device = ("gp.", "api.")


def read(run):
    got = spans.spans_of(run, "model_device_ms")
    return None if got is None else spans.model_device_ms(got)
