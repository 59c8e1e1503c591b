"""Render the card's golden sweeps as the headline table: the counterpart
of ``tools/report.py``.

Reads ``bench_results/golden_h100_{s,d,c,z}.jsonl`` (written by
``python -m cholesky_tpu_torch.tools.sweep``) and prints, per dtype × op,
the best GFLOP/s row with its size, its variant, the points and failures
recorded, the largest max_err / tol of its scored rows, and the ratio to
the reference's baseline where BASELINE.md has a comparable number. The
header names the card of the rows.

A row "passed" when its max_err is within ``tol``, the sweep's analytic
bound (the JAX harness's ``_tol``), which is loose against an f32 kernel's
real error: the max_err / tol column shows how far inside it each op
stays, so that a drift in precision shows before it fails a row.

    python -m cholesky_tpu_torch.tools.report [--dir bench_results] [--md]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# reference baselines (GFLOP/s) from BASELINE.md (benchmark_base.tar.gz);
# all are FP32 on the reference's development GPU — its d/z tiers have no
# published numbers, so ratios for d/c/z compare against the s baseline
# and are labeled as such.
REF_S = {
    "potrf": 175.0,     # cuspotrf_l.txt @4096
    "potri": 161.0,     # cuspotri_l.txt @4096
    "trtri": 199.0,     # custrtri_l peak
    "lauum": 188.0,     # cuslauum_l peak
    "gemm": 415.0,      # cusgemm_n_n peak
    "gemm_k": 415.0,
    "syrk": 234.0,      # cussyrk peak
    "trmm": 371.0,      # custrmm2 peak
    "trsm": 350.0,      # custrsm_r peak
    "logdet": 175.0,    # factor-dominated
}

GOLDEN = "golden_h100_{}.jsonl"


def load(path: Path) -> list:
    if not path.exists():
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def worst_err_tol(rows: list, op: str):
    """The largest max_err / tol of ``op``'s scored rows, to three
    significant digits (None without one)."""
    ratios = [r["max_err"] / r["tol"] for r in rows
              if r["op"] == op and r.get("tol")]
    return float(f"{max(ratios):.3g}") if ratios else None


def table(rows_by_letter: dict) -> list:
    """One dict per (dtype, op) present: the best-GF/s row and its
    context."""
    out = []
    for letter, rows in rows_by_letter.items():
        best = {}
        for r in rows:
            if "gflops" not in r:
                continue
            cur = best.get(r["op"])
            if cur is None or r["gflops"] > cur["gflops"]:
                best[r["op"]] = r
        for op, r in sorted(best.items()):
            ref = REF_S.get(op)
            out.append({
                "dtype": letter, "op": op, "best_gflops": r["gflops"],
                "at_n": r["n"], "config": r.get("config", "auto"),
                "points": sum(x["op"] == op for x in rows),
                "failed": sum(x["op"] == op and not x.get("passed", False)
                              for x in rows),
                "worst_err_tol": worst_err_tol(rows, op),
                "vs_ref": f"{r['gflops'] / ref:.1f}x s-ref" if ref else "-",
            })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cholesky_tpu_torch.tools.report")
    ap.add_argument("--dir", default="bench_results")
    ap.add_argument("--md", action="store_true",
                    help="emit a GitHub-markdown table")
    args = ap.parse_args(argv)
    d = Path(args.dir)
    rows = {letter: load(d / GOLDEN.format(letter)) for letter in "sdcz"}
    cards = sorted({r.get("card", "no card") for rs in rows.values()
                    for r in rs})
    out = table(rows)
    if args.md:
        print(f"Card: {'; '.join(cards) or 'no golden rows'} "
              f"({d / GOLDEN.format('{s,d,c,z}')})")
        print()
        print("| dtype | op | best GF/s | @n | config | pts (fail) | "
              "max err/tol | vs s-baseline |")
        print("|---|---|---|---|---|---|---|---|")
        for r in out:
            print(f"| {r['dtype']} | {r['op']} | {r['best_gflops']} | "
                  f"{r['at_n']} | {r['config']} | {r['points']} "
                  f"({r['failed']}) | {r['worst_err_tol']} | {r['vs_ref']} |")
    else:
        print(json.dumps({"cards": cards}))
        for r in out:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
