"""The benchmark's own tests, on the CPU unless marked ``cuda``:

    python -m pytest -p no:cacheprovider benchmark/tests -q

Tests marked ``cuda`` run a cell on an NVIDIA card and skip without one
(decided inside the test, never at import)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a benchmark cell on an NVIDIA card; skips "
        "where torch sees no CUDA device")
