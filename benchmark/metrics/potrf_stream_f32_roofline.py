"""potrf_stream_f32 alone at the cell's n, on a dense SPD matrix, as a
percentage of its roofline bound (``counts/potrf_stream_f32.py``,
``peaks.json``). n is the cell's largest factored order capped at the
kernel's whole-matrix limit: above it the recursion factors halves of
that size with this kernel."""

import torch

from benchmark import inputs, kernel_time
from benchmark.counts import potrf_stream_f32 as counts


def read(run):
    from cholesky_tpu_torch.ops.kernels import mega, potrf_stream_f32

    n = min(max(run.call.sizes), mega.STREAM_MAX_N)
    n -= n % mega.NB
    if run.peaks is None or n < mega.NB:
        return None
    g = inputs.generator(run.seed, run.device, stream=1)
    A = inputs.dense_spd(g, n, 100.0, torch.float32, run.device)
    ms = kernel_time.median_ms(potrf_stream_f32, A.clone)
    return kernel_time.share(counts.ops(n), counts.nbytes(n), ms, run.peaks)
