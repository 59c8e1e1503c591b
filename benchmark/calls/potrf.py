"""``cholesky_tpu_torch.potrf(uplo, A)`` on dense SPD matrices made at
set-up, one per size of the mix, called in the mix's order."""

import torch

import cholesky_tpu_torch as ct
from benchmark import compare, inputs, traffic
from benchmark.counts import potrf as potrf_count
from benchmark.reference.lapack import potrf_lower


class Call:
    def __init__(self, config, mix, seed, device):
        if config["uplo"] != "L":
            raise ValueError("the reference factors the lower triangle")
        self.uplo = config["uplo"]
        self.sizes = traffic.sizes(mix, config)
        self.warm_calls = mix.get("warm", 1)
        g = inputs.generator(seed, device)
        dtype = getattr(torch, config["dtype"])
        self.A = [inputs.dense_spd(g, n, config["cond"], dtype, device)
                  for n in self.sizes]

    def _input(self, i):
        return self.A[traffic.pick(i, len(self.A))]

    def warm(self):
        for i in range(len(self.A) * self.warm_calls):
            int(self.run(i)[1])

    def run(self, i):
        return ct.potrf(self.uplo, self._input(i))

    def flops(self, i):
        return potrf_count.flops(self._input(i).shape[0])

    def control(self, kept):
        return {i: potrf_lower(self._input(i), "tf32")[0] for i in kept}

    def numbers(self, kept):
        errs = []
        for j in sorted({traffic.pick(i, len(self.A)) for i in kept}):
            ref, info = potrf_lower(self.A[j], "f64")
            if info:
                raise RuntimeError(f"input {j} is not positive definite")
            errs += [compare.tril_rel_err(kept[i], ref) for i in kept
                     if traffic.pick(i, len(self.A)) == j]
            del ref
        return {"factor_err": compare.worst(errs)}
