"""Record the card's golden sweep of one precision, in chunks.

    python -m cholesky_tpu_torch.tools.goldens LETTER [--out FILE]

The point set is the (op, config, n) set of the JAX package's golden
record ``bench_results/golden_tpu_v5_lite_<letter>.jsonl`` (its op,
config and n only; none of its numbers is read) with n up to ``CAP``
(8192 for s, 4096 for d, c and z: larger points' float64 numpy oracles
would take most of the run). Each (op, config) group runs as one
``tools.sweep`` invocation with ``--resume`` into ``--out`` (default
``bench_results/golden_h100_<letter>.jsonl``), so a chunk cut short keeps
every point it finished and the next chunk skips them. Exits 0 when every
point of the set is in the file and every row passed, 2 while points
remain or a row failed. Card only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from cholesky_tpu_torch.tools import sweep

CAP = {"s": 8192, "d": 4096, "c": 4096, "z": 4096}


def point_set(path, max_n: int) -> dict:
    """{(op, config): [n, ...]} of a golden record, n <= max_n."""
    groups = {}
    for r in sweep.load_rows(path):
        if r["n"] <= max_n:
            key = (r["op"], sweep.norm_cfg(r["op"], r.get("config")))
            groups.setdefault(key, set()).add(r["n"])
    return {k: sorted(v) for k, v in sorted(groups.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cholesky_tpu_torch.tools.goldens")
    ap.add_argument("letter", choices=list("sdcz"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2] / "bench_results"
    out = Path(args.out or root / f"golden_h100_{args.letter}.jsonl")
    groups = point_set(root / f"golden_tpu_v5_lite_{args.letter}.jsonl",
                       CAP[args.letter])
    t0 = time.perf_counter()
    for (op, cfg), sizes in groups.items():
        rc = sweep.main(["--dtype", args.letter, "--ops", op, "--config",
                         cfg, "--sizes", ",".join(map(str, sizes)), "--out",
                         str(out), "--resume"])
        if rc == 1:             # no card
            return rc
    rows = sweep.load_rows(out) if out.exists() else []
    have = {sweep.row_key(r) for r in rows}
    missing = [(op, args.letter, cfg, n) for (op, cfg), sizes in
               groups.items() for n in sizes
               if (op, args.letter, cfg, n) not in have]
    failed = [r for r in rows if not r["passed"]]
    print(json.dumps({"letter": args.letter, "rows": len(rows),
                      "missing": len(missing), "failed": len(failed),
                      "seconds": round(time.perf_counter() - t0, 1)}))
    return 0 if not missing and not failed else 2


if __name__ == "__main__":
    sys.exit(main())
