"""The native host task pool (``runtime/csrc/taskpool.cpp``, built with g++
on first use): the counterpart of ``cholesky_tpu/runtime``."""

from cholesky_tpu_torch.runtime.taskpool import Task, TaskPool, TaskPoolError

__all__ = ["Task", "TaskPool", "TaskPoolError"]
