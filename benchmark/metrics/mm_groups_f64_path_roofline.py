"""mm_groups_f64 in the path: every launch of the window at the slices,
shape and update its span recorded, as a share of its roofline
(``counts/mm_groups_f64.py``; the card's dense INT8 tensor-core rate from
``peaks_int8.json``, its memory rate from ``peaks.json``): the sum of the
launches' max(operations / INT8 rate, bytes / memory rate) over the sum
of their CUDA-event times, each pair recorded right around the launch
(``benchmark/spans.py``). A program without the kernel reads None."""

from benchmark import spans
from benchmark.counts import mm_groups_f64 as counts
from benchmark.metrics.mm_groups_f32pair_path_roofline import int8_rate

KERNEL = "kernel.mm_groups_f64"


class Probe(spans.Probe):
    device = (KERNEL,)


def roofline(got, int8_ops_per_s, hbm_bytes_per_s):
    bound_s = ms = 0.0
    for s in got:
        t = s.device_ms() if s.name == KERNEL else None
        if t is not None:
            a = (s.attrs["slices"], s.attrs["m"], s.attrs["n"], s.attrs["k"])
            bound_s += max(counts.ops(*a) / int8_ops_per_s,
                           counts.nbytes(*a, s.attrs["c_read"])
                           / hbm_bytes_per_s)
            ms += t
    return 100.0 * bound_s / (ms / 1e3) if ms > 0.0 else None


def read(run):
    got = spans.spans_of(run, "mm_groups_f64_path_roofline")
    if got is None or run.peaks is None:
        return None
    rate = int8_rate()
    if rate is None:
        return None
    return roofline(got, rate, run.peaks["hbm_bytes_per_s"])
