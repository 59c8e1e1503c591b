from cholesky_tpu_torch.models.gp import (GPParams, gp_nll, gp_nll_and_grads,
                                          gp_predict, gp_train_step,
                                          params_from_jax, rbf_kernel)
from cholesky_tpu_torch.models.gp_dist import make_gp_train_step

__all__ = ["GPParams", "gp_nll", "gp_nll_and_grads", "gp_predict",
           "gp_train_step", "make_gp_train_step", "params_from_jax",
           "rbf_kernel"]
