"""``cholesky_tpu_torch.models.gp.gp_predict`` back to back: the posterior
mean and variance of a fitted GP at a new set of test points each call,
the sets drawn in order from a pool made at set-up."""

import torch

from benchmark import compare, inputs, traffic
from benchmark.counts import potrf, trsm
from benchmark.reference import gp as ref_gp
from cholesky_tpu_torch.models import gp


class Call:
    def __init__(self, config, mix, seed, device):
        self.n, d, self.m = config["n"], config["d"], config["m"]
        self.sizes = [self.n]
        self.jitter = config["jitter"]
        self.warm_calls = mix.get("warm", 1)
        dtype = getattr(torch, config["dtype"])
        g = inputs.generator(seed, device)
        self.X, self.y = inputs.gp_data(g, self.n, d, dtype, device)
        self.Xs = inputs.gp_test_points(g, mix["pool"], self.m, d, dtype,
                                        device)
        self.p = [float(v) for v in config["init"]]
        self.params = gp.GPParams(*(torch.tensor(v, dtype=dtype,
                                                 device=device)
                                    for v in self.p))

    def warm(self):
        for i in range(self.warm_calls):
            int(self.run(i)[1])

    def run(self, i):
        j = traffic.pick(i, len(self.Xs))
        mean, var, info = gp.gp_predict(self.params, self.X, self.y,
                                        self.Xs[j])
        return (j, mean, var), info

    def flops(self, i):
        return potrf.flops(self.n) + trsm.flops(self.n, 2 + self.m)

    def _reference(self, kept, prec):
        sets = [kept[i][0] for i in kept]
        out, info = ref_gp.predict(self.p, self.X, self.y,
                                   [self.Xs[j] for j in sets], self.jitter,
                                   prec)
        return out, info

    def control(self, kept):
        out, _ = self._reference(kept, "tf32")
        return {i: (kept[i][0], *mv) for i, mv in zip(kept, out)}

    def numbers(self, kept):
        out, info = self._reference(kept, "f64")
        if info:
            raise RuntimeError("the reference's K is not positive definite")
        answers = [kept[i] for i in kept]
        return {
            "mean_err": compare.worst(compare.rel_err(a[1], r[0])
                                      for a, r in zip(answers, out)),
            "var_err": compare.worst(compare.rel_err(a[2], r[1])
                                     for a, r in zip(answers, out)),
        }
