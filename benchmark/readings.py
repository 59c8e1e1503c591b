"""The readings a cell's limits are set from, on the card, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 \\
        [--control] [--faults N]

For each seed: set-up and a short window (``SECONDS``) at the cell's own
load through the timed path, then the numbers its check compares (the program's
reading); with ``--control``, the same numbers of the control, the
reference in TF32 put in the program's place on the same sampled calls;
with ``--faults N``, each fault the cell's entry point can have
(``faults.py``), planted from set-up on, on the first N seeds. One JSON
line per seed and kind, then a summary: the largest program reading
and the smallest control and fault readings of each number. Benchmark
runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import faults, harness  # noqa: E402

#: the window of each reading: long enough to finish every call and to
#: keep as many answers as a run does
SECONDS = 2.0


def reading(cell, seed, device="cuda", control=False, seconds=SECONDS):
    """{kind: numbers} of one seed: the program's, and the control's."""
    call = harness.prepare(cell, seed, device)
    sample = harness.Sample(cell.mix.get("sample", 1), seed)
    w = harness.Loop(call, sample).run_for(seconds)
    kept = sample.kept
    out = {"program": {**call.numbers(kept), "failed_calls": w.failed}}
    if control:
        out["control"] = call.numbers(call.control(kept))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", type=int, default=0,
                   help="plant the faults on this many of the seeds")
    args = p.parse_args()
    cell = harness.resolve(args.workload)
    call_name = cell.mix["call"]
    rows = []
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for kind, numbers in reading(cell, seed,
                                     control=args.control).items():
            rows.append((kind, seed, numbers))
            print(json.dumps({"kind": kind, "seed": seed, **numbers}),
                  flush=True)
        if k < args.faults:
            for fault in faults.FAULTS[call_name]:
                with faults.plant(call_name, fault):
                    numbers = reading(cell, seed)["program"]
                rows.append((f"fault:{fault}", seed, numbers))
                print(json.dumps({"kind": f"fault:{fault}", "seed": seed,
                                  **numbers}), flush=True)
    summary = {}
    for kind, _, numbers in rows:
        pick = max if kind == "program" else min
        s = summary.setdefault(kind, {})
        for name, v in numbers.items():
            s[name] = v if name not in s else pick(s[name], v)
    print(json.dumps({"summary": summary, "cell": cell.name,
                      "card": harness.card()}))


if __name__ == "__main__":
    main()
