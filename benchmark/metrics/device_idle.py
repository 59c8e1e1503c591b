"""The share of the profiled sub-window in which no operation ran on the
card, in percent: 1 − (union of the device's intervals) / (the
sub-window's length), from torch.profiler behind guard kernels
(``census.py``). None where the profiler lost kernels of the window."""


def read(run):
    c = run.census
    if c is None or c["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - c["busy_s"] / c["window_s"])
