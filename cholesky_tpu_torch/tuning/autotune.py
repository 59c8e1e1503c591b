"""Tuning-table autotuner for the card: the port of ``tools/autotune.py``.

    python -m cholesky_tpu_torch.tuning.autotune [--quick] [--commit REV]

Runs on a CUDA card (it exits non-zero without one) and writes
``tables/<slug of the card's name>.json`` (``table.table_path``), merged
into the table already there: keys this run did not measure are kept.
Each value is measured where it acts in the port, on the public drivers
under a candidate table that stands in for ``ops.blocked.get_params``
(``standing_in``), never through an option of the library:

- ``{potrf,trtri,lauum}_f32.mega_max_n``: at each size of the sweep, the
  public driver with the cap at that size (one whole-matrix kernel)
  against the cap one tile below it (the recursion ``auto`` then runs:
  halves that re-enter the stream kernels). As in the JAX package, the
  cap is the last size at which the kernel wins and the sweep stops at
  the first size the recursion wins (``crossover_cap``); it never exceeds
  ``mega.STREAM_MAX_N``. The JAX form of the comparison (the recursion
  forced down to ``leaf_nb`` leaves by ``block_size``) is timed for the
  record and goes to stderr only.
- ``potrf_f32.leaf_nb``: the leaf of every recursion ``auto`` runs above
  the caps and of every f32 trsm. Candidates are timed, under the caps
  this run found, on the GP train step at n = 8192 (d = 8, its two
  one-column solves), spotrf at 16384 and strsm of one column at 8192.
  The fastest on the GP step is taken unless on another point it is
  slower than that point's fastest by more than both spreads together;
  then the value in force stays (``choose_leaf_nb``).
- ``_meta``: the card, its power limit, the commit, the rates of
  ``gemm_f32``, ``syrk_lower_f32`` and ``trmm_lln_f32`` at 4096, spotrf and
  ``torch.linalg.cholesky_ex`` at 4096, and every reading above.

``matmul_f32``, ``syrk_f32``, ``trmm_f32`` and ``ozaki_f64`` get no keys:
``gemm_f32`` and ``syrk_lower_f32`` choose their launch per call
(``launch_plan``), ``trmm_lln_f32`` has one tile, and the d tier has one
recursion (``table.py``). The decisions are the pure functions
``crossover_cap``, ``choose_leaf_nb`` and ``merge_tables``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import torch

from cholesky_tpu_torch.ops.kernels import mega
from cholesky_tpu_torch.tuning import table
from cholesky_tpu_torch.utils.benchlib import card, event_times

CROSSOVER_SIZES = {"potrf": (2048, 3072, 4096, 6144, 8192),
                   "trtri": (2048, 3072, 4096, 6144, 8192),
                   "lauum": (2048, 3072, 4096, 8192)}
QUICK_SIZES = (2048, 4096, 8192)
LEAF_CANDIDATES = (256, 512, 1024, 2048)
QUICK_LEAVES = (512, 1024)
#: the leaf candidates' three points: the GP train step at GP_N points,
#: spotrf at POTRF_N and strsm of one column at TRSM_N
GP_N, POTRF_N, TRSM_N = 8192, 16384, 8192
LEAF_PRIMARY = f"GP step {GP_N}"
RATES_N = 4096
NOTE = ("matmul_f32, syrk_f32, trmm_f32 and ozaki_f64 get no keys: "
        "gemm_f32 and syrk_lower_f32 choose their launch per call "
        "(launch_plan in ops/kernels/gemm.py and syrk.py), trmm_lln_f32 "
        "has one 128 x 128 tile, the d tier has one recursion. Rates at "
        "n = 4096, median CUDA-event time of one call; readings in ms as "
        "[median, max - min].")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Decisions: pure functions of the timings
# ---------------------------------------------------------------------------

def crossover_cap(readings, floor: int = mega.MAX_N,
                  hard: int = mega.STREAM_MAX_N, nb: int = mega.NB) -> int:
    """mega_max_n from ``readings``, (n, t_kernel, t_recursion) in sweep
    order: the last n at which the whole-matrix kernel is no slower,
    stopping at the first n the recursion wins (JAX
    ``tune_mega_crossover``); ``floor`` when it never wins, and never a
    size above ``hard`` or off the ``nb`` grid."""
    cap = floor
    for n, t_kernel, t_rec in readings:
        if n > hard or n % nb or t_kernel > t_rec:
            break
        cap = n
    return cap


def losses(rows: dict, candidate, primary: str) -> dict:
    """The points other than ``primary`` where ``candidate`` is slower
    than the fastest candidate by more than both spreads together: {point:
    (the fastest candidate, ms lost)}."""
    out = {}
    for point, (m, s) in rows[candidate].items():
        best = min(rows, key=lambda c: rows[c][point][0])
        mb, sb = rows[best][point]
        if point != primary and m - mb > s + sb:
            out[point] = (best, m - mb)
    return out


def choose_leaf_nb(rows: dict, incumbent: int,
                   primary: str = LEAF_PRIMARY) -> int:
    """leaf_nb from ``rows``, {candidate: {point: (median, spread)}}: the
    fastest candidate on ``primary``, unless it loses on another point
    (:func:`losses`); then ``incumbent``, the value in force, stays."""
    best = min(rows, key=lambda c: rows[c][primary][0])
    return incumbent if losses(rows, best, primary) else best


def merge_tables(existing: dict, new: dict) -> dict:
    """``new`` over ``existing``, op by op: keys this run did not measure
    (in an op, or whole ops) are kept (``tools/autotune.py:258-277``)."""
    merged = {k: dict(v) if isinstance(v, dict) else v
              for k, v in existing.items()}
    for k, v in new.items():
        if isinstance(v, dict):
            merged.setdefault(k, {}).update(v)
        else:
            merged[k] = v
    return merged


# ---------------------------------------------------------------------------
# Measurement on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def standing_in(params: dict):
    """Run the drivers with ``params`` ({op: {key: value}}) over the table
    in force: ``ops.blocked`` reads the table through its own
    ``get_params``, which this replaces until the block ends."""
    from cholesky_tpu_torch.ops import blocked

    real = blocked.get_params

    def get_params(op, device_kind=None):
        p = real(op, device_kind)
        p.update(params.get(op, {}))
        return p

    blocked.get_params = get_params
    try:
        yield
    finally:
        blocked.get_params = real


def stats(times) -> tuple:
    """(median, max - min) of a list of times."""
    times = sorted(times)
    return times[len(times) // 2], times[-1] - times[0]


def event_stats(fn, x, reps: int) -> tuple:
    """(median, spread) in ms of ``fn(x)`` between CUDA events."""
    return stats([t * 1e3 for t in event_times(fn, x, reps=reps)])


def wall_stats(fn, reps: int, warmup: int = 1) -> tuple:
    """(median, spread) in ms of ``fn()`` on the host's clock, each call
    ended by a synchronize: for a host-bound path (the GP step)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return stats(times)


def spd(gen, n):
    from cholesky_tpu_torch.rng import latmc

    return latmc(gen, n, 50.0, torch.float32)


def factor(gen, n):
    """tril(L) of an SPD matrix, the input of trtri and lauum."""
    import cholesky_tpu_torch as ct

    F, info = ct.potrf("L", spd(gen, n))
    if int(info):
        raise RuntimeError(f"autotune: input factor n={n} info {int(info)}")
    return torch.tril(F)


def tune_crossover(gen, op: str, leaf_nb: int, quick: bool):
    """mega_max_n of ``op`` and its readings [n, kernel ms, recursion ms]."""
    import cholesky_tpu_torch as ct

    call = {"potrf": lambda x, **kw: ct.potrf("L", x, **kw)[0],
            "trtri": lambda x, **kw: ct.trtri("L", "N", x, **kw)[0],
            "lauum": lambda x, **kw: ct.lauum("L", x, **kw)}[op]
    key = f"{op}_f32"
    readings = []
    for n in (QUICK_SIZES if quick else CROSSOVER_SIZES[op]):
        if n > mega.STREAM_MAX_N or n % mega.NB:
            break
        A = spd(gen, n) if op == "potrf" else factor(gen, n)
        reps = 10 if n < 8192 else 5
        with standing_in({key: {"mega_max_n": n}}):
            t_k = event_stats(call, A, reps)
        with standing_in({key: {"mega_max_n": n - mega.NB}}):
            t_r = event_stats(call, A, reps)
        t_j = event_stats(lambda x: call(x, block_size=leaf_nb), A, reps)
        flops = n ** 3 / 3
        log(f"  mega {op} n={n}: kernel {t_k[0]:.4f} ms (spread "
            f"{t_k[1]:.4f}, {flops / t_k[0] / 1e6:.0f} GF/s) vs auto's "
            f"recursion {t_r[0]:.4f} ms (spread {t_r[1]:.4f}, "
            f"{flops / t_r[0] / 1e6:.0f} GF/s); JAX form block_size="
            f"{leaf_nb} {t_j[0]:.4f} ms (record only)")
        readings.append([n, list(t_k), list(t_r)])
        del A
        if t_k[0] > t_r[0]:
            break
    cap = crossover_cap([(n, k[0], r[0]) for n, k, r in readings])
    log(f"mega {op} crossover: mega_max_n={cap}")
    return cap, readings


def gp_step(gen, n, d=8):
    """One train step of chip_smoke.py's phase 5 model at n points of d
    features, as a function of no arguments."""
    from cholesky_tpu_torch.models import gp

    dev = gen.device
    X = torch.rand(n, d, device=dev, generator=gen) * 2.0 - 1.0
    w = torch.randn(d, device=dev, generator=gen)
    y = torch.sin(3.0 * X @ w / math.sqrt(d)) + 0.1 * torch.randn(
        n, device=dev, generator=gen)
    p0 = gp.GPParams.init(device=dev)
    _, g0, _ = gp.gp_nll_and_grads(p0, X, y)
    lr = 0.05 / max(abs(float(v)) for v in g0)
    return lambda: gp.gp_train_step(p0, X, y, lr=lr)


def tune_leaf(gen, caps: dict, incumbent: int, quick: bool):
    """leaf_nb and its rows {candidate: {point: [median, spread]}}."""
    import cholesky_tpu_torch as ct

    step = gp_step(gen, GP_N)
    A = spd(gen, POTRF_N)
    L = factor(gen, TRSM_N)
    b = torch.randn(TRSM_N, 1, device=gen.device, generator=gen)
    points = {
        LEAF_PRIMARY: lambda: wall_stats(step, reps=5),
        f"spotrf {POTRF_N}": lambda: event_stats(
            lambda x: ct.potrf("L", x)[0], A, reps=5),
        f"strsm {TRSM_N} x 1": lambda: event_stats(
            lambda x: ct.trsm("L", "L", "N", "N", 1.0, L, x), b, reps=10),
    }
    rows = {}
    for leaf in (QUICK_LEAVES if quick else LEAF_CANDIDATES):
        candidate = merge_tables(caps, {"potrf_f32": {"leaf_nb": leaf}})
        with standing_in(candidate):
            rows[leaf] = {p: list(fn()) for p, fn in points.items()}
        log(f"  leaf_nb={leaf}: " + "; ".join(
            f"{p} {m:.4f} ms (spread {s:.4f})"
            for p, (m, s) in rows[leaf].items()))
    fastest = min(rows, key=lambda c: rows[c][LEAF_PRIMARY][0])
    lost = losses(rows, fastest, LEAF_PRIMARY)
    best = choose_leaf_nb(rows, incumbent, LEAF_PRIMARY)
    log(f"potrf leaf_nb={best}: {fastest} is the fastest on {LEAF_PRIMARY}"
        + "".join(f"; it loses {ms:.4f} ms to {c} on {p}"
                  for p, (c, ms) in lost.items())
        + (f", more than both spreads: {incumbent} stays" if lost else ""))
    return best, rows


def rates(gen) -> dict:
    """The _meta rates at n = 4096."""
    import cholesky_tpu_torch as ct
    from cholesky_tpu_torch.ops import kernels as k

    n = RATES_N
    A = torch.randn(n, n, device=gen.device, generator=gen)
    B = torch.randn(n, n, device=gen.device, generator=gen)
    C = torch.randn(n, n, device=gen.device, generator=gen)
    L = torch.tril(A)
    t_mm = event_stats(lambda x: k.gemm_f32(x, B), A, reps=10)[0] / 1e3
    t_sy = event_stats(lambda c: k.syrk_lower_f32(-1.0, A, 1.0, c), C,
                       reps=10)[0] / 1e3
    t_tr = event_stats(lambda x: k.trmm_lln_f32(L, x), B, reps=10)[0] / 1e3
    S = spd(gen, n)
    t_po = event_stats(lambda x: ct.potrf("L", x), S, reps=10)[0] / 1e3
    t_ch = event_stats(torch.linalg.cholesky_ex, S, reps=10)[0] / 1e3
    fl = n ** 3 / 3 + n ** 2 / 2 + n / 6
    return {"matmul_tflops": round(2 * n ** 3 / t_mm / 1e12, 2),
            "syrk_useful_tflops": round(n ** 3 / t_sy / 1e12, 2),
            "trmm_useful_tflops": round(n ** 3 / t_tr / 1e12, 2),
            "potrf_gflops": round(fl / t_po / 1e9, 1),
            "cholesky_ex_gflops": round(fl / t_ch / 1e9, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="three sizes a crossover, two leaf candidates")
    ap.add_argument("--commit", default="not recorded",
                    help="the commit of the tree measured, for _meta")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("autotune: no CUDA device")
        return 1
    import cholesky_tpu_torch  # noqa: F401  (TF32 off)

    kind = torch.cuda.get_device_name(0)
    line = card()
    log(f"tuning on: {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaf_nb = table.get_params("potrf_f32", kind)["leaf_nb"]
    new, readings = {}, {}
    for op in ("potrf", "trtri", "lauum"):
        cap, readings[f"{op}_f32.mega_max_n"] = tune_crossover(
            gen, op, leaf_nb, args.quick)
        new[f"{op}_f32"] = {"mega_max_n": cap}
    leaf, readings["potrf_f32.leaf_nb"] = tune_leaf(gen, dict(new), leaf_nb,
                                                    args.quick)
    new["potrf_f32"]["leaf_nb"] = leaf
    new["_meta"] = {"device_kind": kind, "card": line,
                    "power_limit": line.split(",")[-1].strip(),
                    "commit": args.commit, "note": NOTE,
                    "readings": readings, **rates(gen)}

    path = table.table_path(kind)
    path.parent.mkdir(parents=True, exist_ok=True)
    existing = json.loads(path.read_text()) if path.exists() else {}
    merged = merge_tables(existing, new)
    path.write_text(json.dumps(merged, indent=2, sort_keys=True) + "\n")
    log(f"wrote {path}")
    print(json.dumps(merged))
    return 0


if __name__ == "__main__":
    sys.exit(main())
