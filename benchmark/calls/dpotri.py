"""``cholesky_tpu_torch.dpotrf("L", A)`` then ``dpotri("L", F)`` on dense
float64 SPD matrices made at set-up: the inverse of an SPD matrix in
double precision, one input of the pool a call, in order."""

import torch

import cholesky_tpu_torch as ct
from benchmark import compare, inputs, traffic
from benchmark.counts import potrf as potrf_count
from benchmark.counts import potri as potri_count
from benchmark.reference.lapack import potrf_lower
from benchmark.reference.potri import potri_lower


class Call:
    def __init__(self, config, mix, seed, device):
        if config["uplo"] != "L":
            raise ValueError("the reference inverts from the lower factor")
        self.uplo = config["uplo"]
        self.sizes = traffic.sizes(mix, config)
        self.warm_calls = mix.get("warm", 1)
        g = inputs.generator(seed, device)
        dtype = getattr(torch, config["dtype"])
        self.A = [inputs.dense_spd(g, n, config["cond"], dtype, device)
                  for n in self.sizes for _ in range(mix.get("pool", 1))]

    def _pick(self, i):
        return traffic.pick(i, len(self.A))

    def warm(self):
        for i in range(len(self.A) * self.warm_calls):
            int(self.run(i)[1])

    def run(self, i):
        F, i1 = ct.dpotrf(self.uplo, self.A[self._pick(i)])
        inv, i2 = ct.dpotri(self.uplo, F)
        return (F, inv), torch.where(i1 != 0, i1, i2)

    def flops(self, i):
        n = self.A[self._pick(i)].shape[0]
        return potrf_count.flops(n) + potri_count.flops(n)

    def control(self, kept):
        """The reference in float32: the factor by
        ``torch.linalg.cholesky``, the inverse by ``potri_lower``."""
        out = {}
        for i in kept:
            L = torch.linalg.cholesky(self.A[self._pick(i)].float())
            out[i] = (L, potri_lower(L, "f32"))
        return out

    def numbers(self, kept):
        factor, inverse = [], []
        for j in sorted({self._pick(i) for i in kept}):
            L, info = potrf_lower(self.A[j], "f64")
            if info:
                raise RuntimeError(f"input {j} is not positive definite")
            ref = potri_lower(L, "f64")
            for i in kept:
                if self._pick(i) == j:
                    factor.append(compare.tril_rel_err(kept[i][0], L))
                    inverse.append(compare.tril_rel_err(kept[i][1], ref))
            del L, ref
        return {"factor_err": compare.worst(factor),
                "inv_err": compare.worst(inverse)}
