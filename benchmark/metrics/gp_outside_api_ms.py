"""Device-stream ms of a GP call spent outside the port's LAPACK and BLAS
entry points, per call: the CUDA-event span of the call minus the spans
of its top-level calls into ``cholesky_tpu_torch.ops.api`` (torch's
elementwise passes, kernel matrices, reductions, and the host's gaps
between them). ``models/gp.py`` looks the entry points up on that module
at call time, so the probe wraps them there, in traced runs only. A call
with no span inside fails the run: a renamed entry point cannot make the
metric read the whole call."""

import statistics

import torch


class Probe:
    def __init__(self):
        from cholesky_tpu_torch.ops import api

        self.api = api
        self.names = [n for n in dir(api)
                      if not n.startswith("_") and callable(getattr(api, n))]
        self.saved, self.calls, self.inner, self.depth = {}, [], None, 0

    def _wrap(self, fn):
        def spanned(*args, **kwargs):
            if self.depth == 0:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                if self.depth == 0:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.inner.append((start, end))
        return spanned

    def __enter__(self):
        for n in self.names:
            self.saved[n] = getattr(self.api, n)
            setattr(self.api, n, self._wrap(self.saved[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.api, n, fn)

    def before_call(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        self.inner = []

    def after_call(self):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.calls.append((self.start, end, self.inner))


def read(run):
    probe = run.probes.get("gp_outside_api_ms")
    if probe is None or not probe.calls:
        return None
    torch.cuda.synchronize()
    outside = []
    for start, end, inner in probe.calls:
        if not inner:
            raise RuntimeError("a GP call made no call into "
                               "cholesky_tpu_torch.ops.api")
        outside.append(start.elapsed_time(end)
                       - sum(a.elapsed_time(b) for a, b in inner))
    return statistics.fmean(outside)
