"""``cholesky_tpu_torch.parallel.launch.spawn``: a world of gloo ranks on
the CPU returns every rank's result in rank order, and a failing or
stalled rank makes it raise within its timeout instead of hanging. The
rank functions are in tests/torch_dist_ranks.py, which imports no JAX."""

import time

import pytest

from cholesky_tpu_torch.parallel import launch
from tests import torch_dist_ranks as ranks


def test_spawn_returns_each_rank_in_order():
    # the time limit of the suite's other worlds: three ranks start in
    # about 4 s alone, 15-18 s beside the dist tier's test files at a load
    # of 35 on eight cores, and the limit only ends a world that hangs
    assert launch.spawn(3, ranks.fail_on, -1, timeout=600.0) == [0, 1, 2]


def test_spawn_raises_when_a_rank_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn(2, ranks.fail_on, 1, timeout=120.0)
    assert time.monotonic() - t0 < 60.0


def test_spawn_raises_when_a_rank_overruns_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 of 2 ranks gave no result"):
        launch.spawn(2, ranks.stall, 600.0, timeout=6.0)
    assert time.monotonic() - t0 < 60.0
