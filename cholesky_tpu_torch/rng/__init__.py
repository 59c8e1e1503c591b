from cholesky_tpu_torch.rng.generators import latmc

__all__ = ["latmc"]
