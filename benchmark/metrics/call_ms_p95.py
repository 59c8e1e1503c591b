"""The 95th percentile, over every call of the window, of the host's time
from a call's entry to its read of the call's info, in ms."""

import statistics


def read(run):
    ms = [1e3 * s for s in run.window.call_s]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
