"""Benchmark and accuracy sweep with golden records, all four precisions:
the counterpart of ``tools/sweep.py``.

Rebuild of the reference's sweep scripts and golden logs (reference
test/test_gpulapack.sh:4-13 — cuspotrf n=64..4096 step 64 etc.): each
sweep point times the op on the card, checks its max elementwise error
against a float64/complex128 numpy oracle with the eps-scaled analytic
tolerance (reference test/blas/sgemm.c:160-166), and writes one JSON line

  {"op", "dtype", "config", "backend", "n", "time_ms", "gflops", "info",
   "max_err", "tol", "passed", "card"}

``card`` is the card's name and power limit as ``nvidia-smi`` gives them
(``benchlib.card()``), or "cpu" for a ``--cpu`` run. Each row goes to
``--out`` and, once its oracle has scored it, to standard output.

Timing is ``utils.benchlib.bench_op``: CUDA events around each call after
a warm-up, the median. The card needs no chained program:
``torch.cuda.synchronize()`` waits for it. ``--max-chain`` caps the
number of timed calls. ``--cpu`` runs the port's CPU path (plain torch)
timed by ``time.perf_counter`` medians; such rows carry ``card`` "cpu"
and are only ever compared with other "cpu" rows. Without a card and
without ``--cpu`` the sweep exits non-zero and writes no row.

Precisions (reference single2double.sh / complex2doublecomplex.sh tiers):
  --dtype s   float32 (the f32 CUDA kernels)
  --dtype d   float64 (on the card, the Ozaki int8 slice products)
  --dtype c/z complex64/complex128 tensors; on the card ``auto`` routes
              them through the real embedding onto the s and d kernels

The numpy oracles run on host cores on the native task pool
(``cholesky_tpu_torch.runtime``) while the next point builds its
fixtures; every outstanding oracle has finished before a point's first
call, so no timed call shares the host's cores with an oracle (the d and
z drivers are bound by the host).

Usage:
  python -m cholesky_tpu_torch.tools.sweep --ops potrf,potri \\
      --sizes 256:2048:256 --out bench_results/sweep_torch.jsonl
  python -m cholesky_tpu_torch.tools.sweep ... --golden \\
      bench_results/golden_h100_s.jsonl                       # compare
  python -m cholesky_tpu_torch.tools.sweep --dtype d --resume \\
      --out bench_results/golden_h100_d.jsonl                  # accumulate
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time
import traceback
from collections import deque
from pathlib import Path

import numpy as np
import torch

from cholesky_tpu_torch.ops import blocked, lapack_ref
from cholesky_tpu_torch.rng import latmc
from cholesky_tpu_torch.runtime import TaskPool
from cholesky_tpu_torch.utils.benchlib import bench_op, card

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
#: oracle workers on the host
ORACLE_WORKERS = 4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class DT:
    """Per-letter dtype context (the s/d/c/z axis of the reference) on one
    device, with the cap on timed calls (``--max-chain``)."""

    def __init__(self, letter: str, device="cuda", max_reps=None):
        if letter not in ("s", "d", "c", "z"):
            raise ValueError(f"dtype letter must be one of s, d, c, z: "
                             f"{letter!r}")
        self.letter = letter
        self.device = torch.device(device)
        self.max_reps = max_reps
        #: called before a point's op runs (the sweep waits there for the
        #: oracles still running)
        self.settle = lambda: None
        self.real = letter in "sd"
        self.rdt = torch.float32 if letter in "sc" else torch.float64
        self.cdt = {"s": torch.float32, "d": torch.float64,
                    "c": torch.complex64, "z": torch.complex128}[letter]
        # complex arithmetic = 4 real flops per multiply-add
        self.flop_factor = 1.0 if self.real else 4.0
        self.eps = EPS32 if letter in "sc" else EPS64
        # d/z on the card run on Ozaki int8 slices (z on the embedding of
        # d): the slice-split error model is wider than native-f64 rounding
        self.fudge = 16.0 if (letter in "dz"
                              and self.device.type == "cuda") else 1.0

    # -- fixtures ----------------------------------------------------------

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def hpd(self, n, cond=100.0):
        return latmc(self.generator(n), n, cond, self.cdt)

    def chol_factor(self, n, uplo="L"):
        F, _ = blocked.potrf(uplo, self.hpd(n), backend="auto")
        return self.tri(F, uplo)

    def rect(self, rows, cols, seed):
        """Entries uniform in [−½, ½) (real and imaginary parts)."""
        g = self.generator(seed)

        def plane():
            return torch.rand((rows, cols), generator=g, dtype=self.rdt,
                              device=self.device) - 0.5

        r = plane()
        return r if self.real else torch.complex(r, plane())

    def rand(self, n, seed_off=0):
        return self.rect(n, n, n + seed_off)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def tri(X, uplo, k=0):
        return torch.tril(X, k) if uplo == "L" else torch.triu(X, k)

    def trans_char(self):
        """The 'transposed' variant letter: conjugate-transpose for the
        complex tiers (the case the reference's c/z logs sweep)."""
        return "T" if self.real else "C"

    @staticmethod
    def to_np(X):
        """numpy f64/c128 copy of a tensor."""
        x = X.detach().cpu().numpy()
        return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _reps(n, dt: DT) -> int:
    """Timed calls a point: enough for a stable median, few enough that
    the large d/z points stay in seconds."""
    r = 20 if n <= 1024 else 10 if n <= 4096 else 5
    if dt.letter in "dz":
        r = max(3, r // 2)
    return r if dt.max_reps is None else max(1, min(r, dt.max_reps))


def _time(f, x, n, dt: DT):
    """(median seconds a call, f(x)): the first call gives the value and
    warms up (kernel build, library handles); then CUDA events on the
    card, ``perf_counter`` on the host. ``dt.settle()`` runs first."""
    dt.settle()
    out = f(x)
    reps = _reps(n, dt)
    if dt.device.type == "cuda":
        return bench_op(f, x, warmup=1, reps=reps), out
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f(x)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def _tol(dt: DT, fpe, scale, n=0):
    if dt.fudge > 1.0:
        # Ozaki tiers carry a slice-quantization floor (~2^-42 per
        # product) that does NOT shrink with the op's flop count — a
        # low-flop op like lauum (fpe=2n+3) would otherwise get a bound
        # below the representation floor of the int8-slice arithmetic
        fpe = max(fpe, 60 * n)
    return fpe * 2.0 * dt.eps * dt.fudge * max(1.0, scale)


# --- per-op sweep points: return (sec, flops, oracle, fpe, info) ----------
#
# Every point takes a variant ``cfg``. Encodings:
#   potrf/potri/lauum/logdet: "l" | "u"            (uplo)
#   trtri:                    "ln"|"un"|"lu"|"uu"  (uplo, diag)
#   gemm:                     "nn"|"nt"|"tn"|"tt"  (transa, transb)
#   syrk:                     "ln"|"lt"|"un"|"ut"  (uplo, trans)
#   trmm/trsm:                "llnn" …             (side, uplo, transa, diag)
# For complex tiers a "t" position means the conjugate transpose.

def point_potrf(n, backend, dt: DT, cfg="l"):
    uplo = cfg.upper()
    tri = np.tril if uplo == "L" else np.triu
    A = dt.hpd(n)
    sec, (F, info) = _time(lambda a: blocked.potrf(uplo, a, backend=backend),
                           A, n, dt)
    Fnp = tri(dt.to_np(F))
    Anp = dt.to_np(A)

    def oracle():
        ref = np.linalg.cholesky(Anp)
        if uplo == "U":
            ref = ref.conj().T
        return float(np.max(np.abs(Fnp - ref))), float(np.max(np.abs(ref)))

    # fpe carries the fixture's cond=100 forward-error amplification: the
    # oracle is exact-f64 Cholesky, so |impl - ref| ~ kappa * eps * n
    return sec, dt.flop_factor * (n ** 3 / 3 + n ** 2 / 2), oracle, \
        100 * n, int(info)


def point_potri(n, backend, dt: DT, cfg="l"):
    uplo = cfg.upper()
    tri = np.tril if uplo == "L" else np.triu
    F = dt.chol_factor(n, uplo)
    sec, (Inv, info) = _time(lambda a: blocked.potri(uplo, a, backend=backend),
                             F, n, dt)
    Invnp = tri(dt.to_np(Inv))
    Fnp = tri(dt.to_np(F))
    Anp = Fnp @ Fnp.conj().T if uplo == "L" else Fnp.conj().T @ Fnp

    def oracle():
        ref = tri(np.linalg.inv(Anp))
        return float(np.max(np.abs(Invnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * 2 * n ** 3 / 3, oracle, 3000 * n, int(info)


def point_trtri(n, backend, dt: DT, cfg="ln"):
    uplo, diag = cfg[0].upper(), cfg[1].upper()
    tri = np.tril if uplo == "L" else np.triu
    A = dt.chol_factor(n, uplo)
    sec, (R, info) = _time(
        lambda a: blocked.trtri(uplo, diag, a, backend=backend), A, n, dt)
    k = -1 if uplo == "L" else 1
    Rnp = dt.to_np(dt.tri(R, uplo))
    Anp = tri(dt.to_np(A))
    if diag == "U":
        # unit-diag contract: only the strict triangle of the output is
        # defined (diagonal passes through untouched)
        Rnp = tri(Rnp, k)

    def oracle():
        T = Anp.copy()
        if diag == "U":
            np.fill_diagonal(T, 1.0)
        ref = tri(np.linalg.inv(T))
        ref = tri(ref, k) if diag == "U" else tri(ref)
        return float(np.max(np.abs(tri(Rnp) - ref))), \
            float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3 / 3, oracle, 60 * n, int(info)


def point_lauum(n, backend, dt: DT, cfg="l"):
    uplo = cfg.upper()
    tri = np.tril if uplo == "L" else np.triu
    A = dt.chol_factor(n, uplo)
    sec, R = _time(lambda a: blocked.lauum(uplo, a, backend=backend), A, n,
                   dt)
    Rnp = tri(dt.to_np(R))
    Anp = tri(dt.to_np(A))

    def oracle():
        # LAPACK xLAUUM: uplo=L -> Lᴴ·L, uplo=U -> U·Uᴴ
        ref = tri(Anp.conj().T @ Anp if uplo == "L" else Anp @ Anp.conj().T)
        return float(np.max(np.abs(Rnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3 / 3, oracle, 2 * n + 3, 0


def point_logdet(n, backend, dt: DT, cfg="l"):
    uplo = cfg.upper()
    A = dt.hpd(n, cond=30.0)
    sec, (val, info) = _time(
        lambda a: blocked.logdet(uplo, a, backend=backend), A, n, dt)
    Anp = dt.to_np(A)
    v = float(val)

    def oracle():
        _, ref = np.linalg.slogdet(Anp)
        return float(abs(v - ref)), float(abs(ref))

    return sec, dt.flop_factor * n ** 3 / 3, oracle, 60 * n, int(info)


def point_logdet_diag(n, backend, dt: DT, cfg="auto"):
    """Bandwidth-metric logdet from a factored diagonal, to n = 2^20 —
    the reference's cuslogdet sweep (test/benchmark_base cuslogdet.txt,
    strided-vector entry slogdet.c:10-25). 'gflops' field = GB/s here."""
    d = torch.rand((n,), generator=dt.generator(n), dtype=dt.rdt,
                   device=dt.device) + 0.5
    sec, val = _time(lapack_ref.logdet_from_factor, d, min(n, 8192), dt)
    dn = dt.to_np(d)
    v = float(val)

    def oracle():
        ref = 2.0 * float(np.sum(np.log(dn)))
        return float(abs(v - ref)), float(abs(ref))

    # report bytes moved (one read of the vector) — bandwidth, not flops
    nbytes = n * (4 if dt.letter in "sc" else 8)
    return sec, nbytes, oracle, 60 * max(1, n // 1024), 0


def _op(M, t):
    return M if t == "N" else (M.T if t == "T" else M.conj().T)


def point_gemm(n, backend, dt: DT, cfg="nn"):
    ta = "N" if cfg[0] == "n" else dt.trans_char()
    tb = "N" if cfg[1] == "n" else dt.trans_char()
    A, B, C = dt.rand(n, 0), dt.rand(n, 1), dt.rand(n, 2)
    sec, D = _time(lambda a: blocked.gemm(ta, tb, 1.0, a, B, -1.0, C,
                                          backend=backend), A, n, dt)
    Dnp = dt.to_np(D)
    An, Bn, Cn = dt.to_np(A), dt.to_np(B), dt.to_np(C)

    def oracle():
        ref = _op(An, ta) @ _op(Bn, tb) - Cn
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * 2 * n ** 3, oracle, 2 * n + 3, 0


def point_gemm_k(k, backend, dt: DT, cfg="nn"):
    """Rectangular GEMM with m = n = 1024 fixed and the contraction dim
    swept via the sizes axis — the reference's k-sweeps
    (reference test/test_gpublas.sh:5-25, cusgemm_*.txt logs)."""
    M = 1024
    ta = "N" if cfg[0] == "n" else dt.trans_char()
    tb = "N" if cfg[1] == "n" else dt.trans_char()

    def rect(rows, cols, off):
        return dt.rect(rows, cols, rows * 7 + cols * 13 + off)

    A = rect(M, k, 0) if ta == "N" else rect(k, M, 0)
    B = rect(k, M, 1) if tb == "N" else rect(M, k, 1)
    C = rect(M, M, 2)
    sec, D = _time(lambda a: blocked.gemm(ta, tb, 1.0, a, B, -1.0, C,
                                          backend=backend), A, max(k, 256),
                   dt)
    Dnp = dt.to_np(D)
    An, Bn, Cn = dt.to_np(A), dt.to_np(B), dt.to_np(C)

    def oracle():
        ref = _op(An, ta) @ _op(Bn, tb) - Cn
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * 2 * M * M * k, oracle, 2 * k + 3, 0


def point_syrk(n, backend, dt: DT, cfg="ln"):
    uplo = cfg[0].upper()
    trans = "N" if cfg[1] == "n" else dt.trans_char()
    tri = np.tril if uplo == "L" else np.triu
    A, C = dt.rand(n, 0), dt.rand(n, 1)
    if dt.real:
        sec, D = _time(lambda a: blocked.syrk(uplo, trans, -1.0, a, 1.0, C,
                                              backend=backend), A, n, dt)
    else:
        # complex tier: the Hermitian rank-k update is HERK
        Ch = dt.tri(C, uplo)  # only the triangle is read; diag im ignored
        sec, D = _time(lambda a: blocked.herk(uplo, trans, -1.0, a, 1.0, Ch,
                                              backend=backend), A, n, dt)
    Dnp = tri(dt.to_np(dt.tri(D, uplo)))
    An = dt.to_np(A)
    Cn = tri(dt.to_np(C))
    if not dt.real:
        Cn = Cn - 1j * np.diag(np.diag(Cn).imag)

    def oracle():
        if dt.real:
            P = An @ An.T if trans == "N" else An.T @ An
        else:
            P = An @ An.conj().T if trans == "N" else An.conj().T @ An
        ref = tri(-P + Cn)
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3, oracle, 2 * n + 3, 0


def _trimat(An, uplo, diag, transa):
    """numpy op(tri(A)) for a trmm/trsm variant."""
    T = np.tril(An) if uplo == "L" else np.triu(An)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    return _op(T, transa)


def point_trmm(n, backend, dt: DT, cfg="llnn"):
    side, uplo, diag = cfg[0].upper(), cfg[1].upper(), cfg[3].upper()
    transa = "N" if cfg[2] == "n" else dt.trans_char()
    A = dt.chol_factor(n, uplo)
    B = dt.rand(n, 1)
    sec, D = _time(lambda b: blocked.trmm(side, uplo, transa, diag, 1.0, A,
                                          b, backend=backend), B, n, dt)
    Dnp = dt.to_np(D)
    An = dt.to_np(A)
    Bn = dt.to_np(B)

    def oracle():
        T = _trimat(An, uplo, diag, transa)
        ref = T @ Bn if side == "L" else Bn @ T
        return float(np.max(np.abs(Dnp - ref))), float(np.max(np.abs(ref)))

    return sec, dt.flop_factor * n ** 3, oracle, 2 * n + 3, 0


def point_trsm(n, backend, dt: DT, cfg="llnn"):
    side, uplo, diag = cfg[0].upper(), cfg[1].upper(), cfg[3].upper()
    transa = "N" if cfg[2] == "n" else dt.trans_char()
    A = dt.chol_factor(n, uplo)
    B = dt.rand(n, 1)
    sec, X = _time(lambda b: blocked.trsm(side, uplo, transa, diag, 1.0, A,
                                          b, backend=backend), B, n, dt)
    Xnp = dt.to_np(X)
    An = dt.to_np(A)
    Bn = dt.to_np(B)

    def oracle():
        # scaled residual — forward error is cond-limited for triangular
        # solves (reference custrsm tests use ≤1e-6 on tame inputs)
        T = _trimat(An, uplo, diag, transa)
        res = np.max(np.abs((T @ Xnp if side == "L" else Xnp @ T) - Bn))
        scale = np.max(np.abs(Xnp)) * np.max(np.abs(T))
        return float(res / max(scale, 1e-30)), 1.0

    return sec, dt.flop_factor * n ** 3, oracle, 60 * n, 0


POINTS = {
    "potrf": point_potrf, "potri": point_potri, "trtri": point_trtri,
    "lauum": point_lauum, "logdet": point_logdet,
    "logdet_diag": point_logdet_diag,
    "gemm": point_gemm, "gemm_k": point_gemm_k, "syrk": point_syrk,
    "trmm": point_trmm, "trsm": point_trsm,
}

#: the variant a bare sweep records (and what rows with config="auto"
#: measured)
DEFAULT_CFG = {
    "potrf": "l", "potri": "l", "trtri": "ln", "lauum": "l", "logdet": "l",
    "logdet_diag": "auto", "gemm": "nn", "gemm_k": "nn", "syrk": "ln",
    "trmm": "llnn", "trsm": "llnn",
}

#: --config grid: the per-op variant set (reference bar: test_gpulapack.sh
#: sweeps u AND l per routine; custrmm2_*/custrsm_* logs cover the
#: side/uplo/trans grid)
GRID_CFG = {
    "potrf": ["l", "u"], "potri": ["l", "u"],
    "trtri": ["ln", "un", "lu", "uu"],
    "lauum": ["l", "u"], "logdet": ["l", "u"], "logdet_diag": ["auto"],
    "gemm": ["nn", "nt", "tn", "tt"],
    "gemm_k": ["nn", "nt", "tn", "tt"],
    "syrk": ["ln", "lt", "un", "ut"],
    "trmm": ["llnn", "lltn", "lunn", "lutn",
             "rlnn", "rltn", "runn", "rutn"],
    "trsm": ["llnn", "lltn", "lunn", "lutn",
             "rlnn", "rltn", "runn", "rutn"],
}


def norm_cfg(op: str, cfg: str | None) -> str:
    """Map a recorded config to a variant key. Rows that stored the
    BACKEND in "config" (always "auto") measured the default variant."""
    if cfg in GRID_CFG.get(op, ()):
        return cfg
    return DEFAULT_CFG.get(op, "auto")


def row_key(r) -> tuple:
    return (r["op"], r.get("dtype", "s"), norm_cfg(r["op"], r.get("config")),
            r["n"])


def parse_sizes(spec: str) -> list:
    if ":" in spec:
        start, stop, step = (int(x) for x in spec.split(":"))
        return list(range(start, stop + 1, step))
    return [int(x) for x in spec.split(",")]


def load_rows(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_golden(path, label: str):
    """The golden rows measured on the card named ``label``, by key; None
    (with a message) for a file whose rows do not all name their card:
    a row without ``card`` (every TPU golden) is never compared with a
    number from the card."""
    rows = load_rows(path)
    unnamed = sum("card" not in g for g in rows)
    if unnamed:
        log(f"refused golden file {path}: {unnamed} of {len(rows)} rows name "
            "no card; it can only be compared with rows measured on the "
            "same card")
        return None
    same = {row_key(g): g for g in rows if g["card"] == label}
    log(f"golden {path}: {len(same)} of {len(rows)} rows measured on "
        f"{label!r}")
    return same


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cholesky_tpu_torch.tools.sweep",
        description="Benchmark and accuracy sweep of the PyTorch port.")
    ap.add_argument("--ops", default=",".join(POINTS),
                    help="comma list of sweep points (default: all eleven)")
    ap.add_argument("--sizes", default="256:2048:256",
                    help="start:stop:step (inclusive stop), or comma list")
    ap.add_argument("--dtype", default="s", choices=list("sdcz"))
    ap.add_argument("--backend", default="auto",
                    help="the port's backend (auto: the CUDA kernels, the "
                         "Ozaki d tier and the embedding on the card)")
    ap.add_argument("--config", default="default",
                    help="variant axis: 'default' (one variant per op), "
                         "'grid' (the per-op GRID_CFG set), or a comma "
                         "list like 'l,u' / 'llnn,rutn' applied to every "
                         "selected op")
    ap.add_argument("--out", default="bench_results/sweep_torch.jsonl")
    ap.add_argument("--golden", default=None,
                    help="compare gflops against the rows of a golden jsonl "
                         "measured on the same card (±30%%)")
    ap.add_argument("--resume", action="store_true",
                    help="append to --out, skipping points already present")
    ap.add_argument("--max-chain", type=int, default=None,
                    help="cap the timed calls a point")
    ap.add_argument("--cpu", action="store_true",
                    help="run the port's CPU path, timed on the host clock "
                         "(rows carry card 'cpu')")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        log("sweep: no CUDA card (torch.cuda.is_available() is false); "
            "--cpu runs the CPU path, whose rows are never a card's")
        return 1
    label = "cpu" if args.cpu else card()
    golden = None
    if args.golden:
        golden = load_golden(args.golden, label)
        if golden is None:
            return 3

    dt = DT(args.dtype, "cpu" if args.cpu else "cuda", args.max_chain)
    backend = args.backend
    sizes = parse_sizes(args.sizes)
    ops = args.ops.split(",")
    unknown = [op for op in ops if op not in POINTS]
    if unknown:
        log(f"sweep: unknown ops {unknown}; known: {sorted(POINTS)}")
        return 3
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    log(f"sweep on {label}: dtype {dt.letter}, backend {backend}")

    def cfgs_for(op):
        if args.config == "default":
            return [DEFAULT_CFG[op]]
        if args.config == "grid":
            return GRID_CFG[op]
        want = [c.strip() for c in args.config.split(",") if c.strip()]
        return [c for c in want if c in GRID_CFG.get(op, ())] or \
            [DEFAULT_CFG[op]]

    results = []
    if args.resume and out_path.exists():
        results = load_rows(out_path)
    done = {row_key(r) for r in results}
    fresh = []

    def flush():
        # resumed and finalized rows on disk after EVERY completed point:
        # a chunk cut by its time limit keeps what it measured
        tmp = out_path.with_suffix(out_path.suffix + ".tmp")
        with open(tmp, "w") as f:
            for rec in results + fresh:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, out_path)

    def finalize(rec, holder, task, fpe):
        task.join()
        if "error" in holder:
            rec["error"] = holder["error"]
            rec["passed"] = False
        else:
            tol = _tol(dt, fpe, holder["scale"], rec["n"])
            rec["max_err"] = float(f"{holder['err']:.3e}")
            rec["tol"] = float(f"{tol:.3e}")
            rec["passed"] = bool(holder["err"] <= tol and rec["info"] == 0)
        rec["card"] = label
        fresh.append(rec)
        flush()
        print(json.dumps(rec), flush=True)

    # one slot after another, whatever has been drained: every worker
    # takes its share of the oracles
    slots = itertools.count()
    with TaskPool(ORACLE_WORKERS) as pool:
        oracle_tasks = deque()
        dt.settle = pool.synchronize
        for op in ops:
            for cfg in cfgs_for(op):
                for n in sizes:
                    if (op, dt.letter, cfg, n) in done:
                        continue
                    try:
                        sec, flops, oracle, fpe, info = \
                            POINTS[op](n, backend, dt, cfg)
                    except Exception as e:  # a point must not end the sweep
                        log(f"{op}[{dt.letter}/{cfg}] n={n}: FAILED\n"
                            + traceback.format_exc(limit=4))
                        fresh.append({"op": op, "dtype": dt.letter,
                                      "config": cfg, "backend": backend,
                                      "n": n, "passed": False,
                                      "error": type(e).__name__,
                                      "card": label})
                        flush()
                        continue
                    rec = {"op": op, "dtype": dt.letter, "config": cfg,
                           "backend": backend, "n": n,
                           "time_ms": round(sec * 1e3, 3),
                           "gflops": round(flops / sec / 1e9, 1),
                           "info": info}
                    holder = {}

                    def run_oracle(oracle=oracle, holder=holder):
                        try:
                            err, scale = oracle()
                        except Exception as e:  # reported in the row
                            log("oracle FAILED\n" + traceback.format_exc(
                                limit=4))
                            holder["error"] = f"oracle {type(e).__name__}"
                            err, scale = math.nan, math.nan
                        holder["scale"] = scale
                        holder["err"] = err  # "err" in holder == done
                        return 0

                    task = pool.run(next(slots) % ORACLE_WORKERS, run_oracle)
                    oracle_tasks.append((rec, holder, task, fpe))
                    log(f"{op}[{dt.letter}/{cfg}] n={n}: {rec['gflops']} "
                        f"GF/s ({rec['time_ms']} ms)")
                    # Drain already-verified oracles in order so their rows
                    # hit disk while later points are still measuring.
                    while oracle_tasks and "err" in oracle_tasks[0][1]:
                        finalize(*oracle_tasks.popleft())
        while oracle_tasks:
            finalize(*oracle_tasks.popleft())

    results.extend(fresh)
    with open(out_path, "w") as f:
        for rec in results:
            f.write(json.dumps(rec) + "\n")
    scored = [r for r in results if "max_err" in r or not r["passed"]]
    npass = sum(r["passed"] for r in scored)
    log(f"{npass}/{len(scored)} PASSED -> {out_path}")

    if golden is not None:
        regressions = []
        for r in results:
            g = golden.get(row_key(r))
            if (g and r.get("card") == label and "gflops" in r
                    and r["gflops"] < 0.7 * g["gflops"]):
                regressions.append((r["op"], r["n"], r["gflops"],
                                    g["gflops"]))
        if regressions:
            log("PERF REGRESSIONS (>30% below golden):")
            for op, n, got, want in regressions:
                log(f"  {op} n={n}: {got} vs golden {want} GF/s")
            return 1
        log("no perf regressions vs golden")

    return 0 if npass == len(scored) else 2


if __name__ == "__main__":
    sys.exit(main())
