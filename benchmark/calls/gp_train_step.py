"""``cholesky_tpu_torch.models.gp.gp_train_step`` back to back on one data
set, the parameters carried from step to step as a fit carries them.

Set-up builds the one state the window goes on with: the data, and the
parameters driven from ``config["init"]`` through the mix's first steps by
the window's own call. The check follows those steps with the reference:
each step's NLL, the first gradient as worked out from the parameters
after one step, and the parameters' change after the last, each by the
worst leaf (log_amp, log_len, log_noise)."""

import torch

from benchmark import compare, inputs
from benchmark.counts import potrf, potri, trsm
from benchmark.reference import gp as ref_gp
from cholesky_tpu_torch.models import gp


class Call:
    def __init__(self, config, mix, seed, device):
        self.n, d = config["n"], config["d"]
        self.sizes = [self.n]
        self.jitter = config["jitter"]
        self.lr = config["lr_per_point"] / self.n
        self.first_steps = mix["first_steps"]
        dtype = getattr(torch, config["dtype"])
        self.X, self.y = inputs.gp_data(inputs.generator(seed, device),
                                        self.n, d, dtype, device)
        self.p0 = [float(v) for v in config["init"]]
        self.params = gp.GPParams(*(torch.tensor(v, dtype=dtype,
                                                 device=device)
                                    for v in self.p0))
        self.first = self.nll = None

    def warm(self):
        after, nlls, infos = [], [], []
        for i in range(self.first_steps):
            info = self.run(i)[1]
            after.append([float(v) for v in self.params])
            nlls.append(float(self.nll))
            infos.append(int(info))
        self.first = (after, nlls, infos)

    def run(self, i):
        self.params, self.nll, info = gp.gp_train_step(
            self.params, self.X, self.y, lr=self.lr)
        return None, info

    def flops(self, i):
        return (potrf.flops(self.n) + potri.flops(self.n)
                + 2 * trsm.flops(self.n, 1))

    def control(self, kept):
        after, nlls, _, infos = ref_gp.train(
            self.p0, self.X, self.y, self.lr, self.first_steps, self.jitter,
            "tf32")
        return after, nlls, infos

    def numbers(self, kept):
        after, nlls, infos = kept or self.first
        r_after, r_nlls, r_grads, r_infos = ref_gp.train(
            self.p0, self.X, self.y, self.lr, self.first_steps, self.jitter)
        if any(r_infos):
            raise RuntimeError(f"the reference's K is not positive definite "
                               f"at a step: info {r_infos}")
        grad = [(a - b) / self.lr for a, b in zip(self.p0, after[0])]
        change = [a - b for a, b in zip(after[-1], self.p0)]
        r_change = [a - b for a, b in zip(r_after[-1], self.p0)]
        return {
            "loss_gap": compare.worst(abs(p - r) / abs(r)
                                      for p, r in zip(nlls, r_nlls)),
            "grad_gap": compare.leaf_gap(grad, r_grads[0], r_grads[0]),
            "change_gap": compare.leaf_gap(change, r_change, r_grads[0]),
            "step_failed": float(sum(i != 0 for i in infos)),
        }
