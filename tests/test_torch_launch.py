"""``cholesky_tpu_torch.parallel.launch.spawn``: a world of gloo ranks on
the CPU returns every rank's result in rank order, and a failing or
stalled rank makes it raise within its timeout instead of hanging. The
rank functions are in tests/torch_dist_ranks.py, which imports no JAX."""

import time

import pytest

from cholesky_tpu_torch.parallel import launch
from tests import torch_dist_ranks as ranks
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401


def test_spawn_returns_each_rank_in_order():
    # three ranks start in about 4 s alone and 5-7 s in the suite under
    # six workers; the limit only ends a world that hangs
    assert launch.spawn(3, ranks.fail_on, -1, timeout=60.0) == [0, 1, 2]


def test_spawn_raises_when_a_rank_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn(2, ranks.fail_on, 1, timeout=30.0)     # 3.5-5 s measured
    assert time.monotonic() - t0 < 60.0


def test_spawn_raises_when_a_rank_overruns_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 of 2 ranks gave no result"):
        launch.spawn(2, ranks.stall, 600.0, timeout=6.0)
    assert time.monotonic() - t0 < 60.0
