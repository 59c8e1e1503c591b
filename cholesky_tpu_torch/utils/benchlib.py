"""Device timing with CUDA events.

The counterpart of ``cholesky_tpu/utils/benchlib.py`` and of the
reference's CUevent loop (test/lapack/cuspotrf.c:129-141): warm up, then
time each call between two events on the current stream and take the
median. The chained-perturbation program that the TPU's remote attachment
forced is not needed here: ``torch.cuda.synchronize()`` waits for the card.
"""

from __future__ import annotations

import torch


def bench_op(op_fn, x, *, warmup: int = 2, reps: int = 10) -> float:
    """Median seconds per ``op_fn(x)`` call, ``x`` a CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError("bench_op times the card: pass a CUDA tensor")
    for _ in range(warmup):
        op_fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        op_fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return sorted(times)[len(times) // 2]
