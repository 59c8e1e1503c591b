"""mm_groups_f32pair in the path: every launch of the window at the
slices and shape its span recorded, as a share of its roofline
(``counts/mm_groups_f32pair.py``; the card's dense INT8 tensor-core rate
from ``peaks_int8.json``, its memory rate from ``peaks.json``): the sum
of the launches' max(operations / INT8 rate, bytes / memory rate) over
the sum of their CUDA-event times, each pair recorded right around the
launch (``benchmark/spans.py``)."""

import json
from pathlib import Path

from benchmark import spans
from benchmark.counts import mm_groups_f32pair as counts

PEAKS = Path(__file__).resolve().parents[1] / "peaks_int8.json"
KERNEL = "kernel.mm_groups_f32pair"


class Probe(spans.Probe):
    device = (KERNEL,)


def int8_rate():
    """The card's dense INT8 rate in operations per second, or None."""
    import torch

    with open(PEAKS) as f:
        entry = json.load(f).get(torch.cuda.get_device_name(0))
    return None if entry is None else entry["int8_ops_per_s"]


def roofline(got, int8_ops_per_s, hbm_bytes_per_s):
    bound_s = ms = 0.0
    for s in got:
        t = s.device_ms() if s.name == KERNEL else None
        if t is not None:
            a = (s.attrs["slices"], s.attrs["m"], s.attrs["n"], s.attrs["k"])
            bound_s += max(counts.ops(*a) / int8_ops_per_s,
                           counts.nbytes(*a) / hbm_bytes_per_s)
            ms += t
    return 100.0 * bound_s / (ms / 1e3) if ms > 0.0 else None


def read(run):
    got = spans.spans_of(run, "mm_groups_f32pair_path_roofline")
    if got is None or run.peaks is None:
        return None
    rate = int8_rate()
    if rate is None:
        return None
    return roofline(got, rate, run.peaks["hbm_bytes_per_s"])
