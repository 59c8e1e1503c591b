"""trtri_stream_f32 alone at the cell's n, on the Cholesky factor of a
dense SPD matrix, as a percentage of its roofline bound
(``counts/trtri_stream_f32.py``, ``peaks.json``): the first kernel of
potri in the GP train step."""

import torch

from benchmark import inputs, kernel_time
from benchmark.counts import trtri_stream_f32 as counts


def read(run):
    from cholesky_tpu_torch.ops.kernels import mega, trtri_stream_f32

    n = min(max(run.call.sizes), mega.STREAM_MAX_N)
    n -= n % mega.NB
    if run.peaks is None or n < mega.NB:
        return None
    g = inputs.generator(run.seed, run.device, stream=1)
    A = inputs.dense_spd(g, n, 100.0, torch.float32, run.device)
    L = torch.linalg.cholesky(A).contiguous()       # unit-stride rows
    ms = kernel_time.median_ms(trtri_stream_f32, lambda: L)
    return kernel_time.share(counts.ops(n), counts.nbytes(n), ms, run.peaks)
