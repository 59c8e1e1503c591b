"""Kernel launches per call over the window: the change of the port's
own counters (``cholesky_tpu_torch.ops.kernels.launch_counts``), summed
over kernels, over the calls. It repeats exactly."""


def read(run):
    if not run.window.calls:
        return None
    return sum(run.launches.values()) / run.window.calls
