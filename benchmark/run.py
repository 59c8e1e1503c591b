"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the last lines of
standard error are the numbers compared, each beside its limit. Without
a CUDA card, or with fewer cards than the cell asks for, it prints no
result and exits with 2; with a JAX module loaded once the window has
closed, with 3.
"""

import time

T_NOW = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the toolchains' caches, inside the checkout at fixed paths, so that only
#: a checkout's first run builds
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_ext",
          "CUDA_CACHE_PATH": "nv"}


def process_start():
    """perf_counter's reading at the start of this process (Linux, to the
    kernel's clock tick), else at the start of this script."""
    t = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return T_NOW
    return min(T_NOW, t - (uptime - ticks / os.sysconf("SC_CLK_TCK")))


def main():
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    return harness.main(args, t_start)


if __name__ == "__main__":
    sys.exit(main())
