"""Device timing with CUDA events.

The counterpart of ``cholesky_tpu/utils/benchlib.py`` and of the
reference's CUevent loop (test/lapack/cuspotrf.c:129-141): warm up, then
time each call between two events on the current stream and take the
median. The chained-perturbation program that the TPU's remote attachment
forced is not needed here: ``torch.cuda.synchronize()`` waits for the card.
"""

from __future__ import annotations

import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (card 0): the
    label every measurement is kept with, since a card set below 700 W
    runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_times(op_fn, x, *, warmup: int = 2, reps: int = 10) -> list:
    """Seconds of each of ``reps`` ``op_fn(x)`` calls, sorted, ``x`` a
    CUDA tensor."""
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
    return sorted(times)


def bench_op(op_fn, x, *, warmup: int = 2, reps: int = 10) -> float:
    """Median seconds per ``op_fn(x)`` call, ``x`` a CUDA tensor."""
    times = event_times(op_fn, x, warmup=warmup, reps=reps)
    return times[len(times) // 2]
