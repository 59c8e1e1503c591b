from cholesky_tpu_torch.rng.device import uniform_device, uniform_device64
from cholesky_tpu_torch.rng.generators import (Interval, interval_transform,
                                               latmc, latmc_pair,
                                               random_triangular, uniform)

__all__ = ["Interval", "interval_transform", "latmc", "latmc_pair",
           "random_triangular", "uniform", "uniform_device",
           "uniform_device64"]
