"""Each cell once on an NVIDIA card, at its full size for one second:

    python -m pytest -p no:cacheprovider benchmark/tests -m cuda

Skips where torch sees no CUDA device."""

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.read_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for trace in (False, True):
        r = harness.run(harness.resolve(name), 2 ** 31 + 5, 1.0, trace)
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu" and r["attempted"] > 0
        assert r["metrics"]
