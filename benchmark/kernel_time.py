"""A kernel alone at a cell's size, timed by CUDA events, and its share of
its roofline: the least time the card could take, the larger of the
operations over the peak rate and the bytes over the memory rate
(``peaks.json``), over the kernel's median time."""

import torch

REPS = 10


def median_ms(launch, make, reps=REPS):
    """Median ms of ``launch(x)`` over ``reps`` launches, each on its own
    input from ``make()``, all made before the clock starts (the kernel
    may work in place), after one warm-up launch."""
    xs = [make() for _ in range(reps + 1)]
    launch(xs.pop())
    torch.cuda.synchronize()
    times = []
    for x in xs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def share(ops, nbytes, ms, peaks):
    """Percent of the roofline bound that a kernel of ``ops`` float32
    operations and ``nbytes`` bytes reaches in ``ms``."""
    bound_s = max(ops / peaks["f32_flops_per_s"],
                  nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * bound_s / (ms / 1e3)
