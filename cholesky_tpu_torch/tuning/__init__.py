from cholesky_tpu_torch.tuning.table import DEFAULTS, get_params

__all__ = ["DEFAULTS", "get_params"]
