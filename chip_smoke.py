#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``cholesky_tpu_torch/ops/kernels/
csrc``, holds each against its plain torch twin at the shapes the main
path gives it, then drives the main path (``potrf`` and ``logdet``, f32,
at n = 4096 and 8192) through the public API and checks, with the launch
counters, that it went through every kernel. Every check raises on
failure, so the script exits non-zero and prints no result line. Needs one
CUDA card; imports nothing of JAX.

The last two lines of standard output are one JSON object per kernel
({"kernels": [...]}) and the result {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

import cholesky_tpu_torch as ct
from cholesky_tpu_torch.ops import kernels
from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.ops.kernels.gemm import gemm_f32, gemm_plain
from cholesky_tpu_torch.ops.kernels.mega import (potrf_block_f32,
                                                 potrf_block_plain,
                                                 trtri_block_f32,
                                                 trtri_block_plain)
from cholesky_tpu_torch.ops.kernels.syrk import (syrk_lower_f32,
                                                 syrk_lower_plain)
from cholesky_tpu_torch.rng import latmc
from cholesky_tpu_torch.utils.benchlib import bench_op

EPS32 = float(torch.finfo(torch.float32).eps)


def flops_potrf(n: int) -> float:
    """The reference's spotrf flop count (bench.py)."""
    return n ** 3 / 3 + n ** 2 / 2 + n / 6


def bound(fpe: float, scale: float) -> float:
    """The repo's analytic tolerance: fpe x 2 x eps x max(1, scale)."""
    return fpe * 2.0 * EPS32 * max(1.0, scale)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def spd(gen, n: int, cond: float = 100.0):
    return latmc(gen, n, cond, torch.float32)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain twin at the main path's shapes
# ---------------------------------------------------------------------------

def check_gemm(gen, rec, on):
    dev = "cuda"
    X = torch.randn(4096, 512, device=dev, generator=gen)
    T = torch.randn(512, 512, device=dev, generator=gen)
    # the leaf product of the panel solve: X·Tᵀ, Tᵀ a transposed view
    got = gemm_f32(X, T.T)
    ref = gemm_plain(X, T.T)
    err = max_err(got, ref)
    b = bound(2 * 512 + 3, float(ref.abs().max()))
    require(err <= b, f"gemm_f32 X·Tᵀ: err {err} > {b}")
    # the trsm update B2 -= X1·Mᵀ in place on a slice view (beta = 1)
    buf = torch.randn(4096, 1024, device=dev, generator=gen)
    M = torch.randn(512, 512, device=dev, generator=gen)
    want = gemm_plain(buf[:, :512], M.T, buf[:, 512:].clone(), alpha=-1.0,
                      beta=1.0)
    left = buf[:, :512].clone()
    B2 = buf[:, 512:]
    gemm_f32(buf[:, :512], M.T, B2, alpha=-1.0, beta=1.0, out=B2)
    err2 = max_err(B2, want)
    b2 = bound(2 * 512 + 3, float(want.abs().max()))
    require(err2 <= b2, f"gemm_f32 in place: err {err2} > {b2}")
    require(torch.equal(buf[:, :512], left), "gemm_f32 wrote outside out")
    D = torch.empty(4096, 512, device=dev)
    ms = bench_op(lambda x: gemm_f32(x, T.T, out=D), X) * 1e3
    plain_ms = bench_op(lambda x: gemm_plain(x, T.T, out=D), X) * 1e3
    print(f"gemm_f32 (4096x512)·(512x512)ᵀ: max err {err:.3e} (bound "
          f"{b:.3e}); in place beta=1 on a view: {err2:.3e} (bound "
          f"{b2:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms on {on}")
    rec["gemm_f32"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_syrk(gen, rec, on):
    # A and C are views of one buffer, as L21 and A22 of the recursion
    buf = torch.randn(2048, 4096, device="cuda", generator=gen)
    A, C = buf[:, :2048], buf[:, 2048:]
    C0 = C.clone()
    want = syrk_lower_plain(-1.0, A, 1.0, C.clone())
    syrk_lower_f32(-1.0, A, 1.0, C)
    low = torch.ones(2048, 2048, dtype=torch.bool, device="cuda").tril_()
    err = max_err(torch.where(low, C, 0.0), torch.where(low, want, 0.0))
    b = bound(2 * 2048 + 3, float(want.abs().max()))
    require(err <= b, f"syrk_lower_f32: err {err} > {b}")
    require(torch.equal(torch.where(low, 0.0, C), torch.where(low, 0.0, C0)),
            "syrk_lower_f32 changed the strict upper of C")
    ms = bench_op(lambda c: syrk_lower_f32(-1e-3, A, 1.0, c), C) * 1e3
    plain_ms = bench_op(lambda c: syrk_lower_plain(-1e-3, A, 1.0, c), C) * 1e3
    print(f"syrk_lower_f32 n=2048 k=2048: max err {err:.3e} (bound "
          f"{b:.3e}), strict upper unchanged bit for bit; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms on {on}")
    rec["syrk_lower_f32"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_potrf_block(gen, rec, on):
    for n in (128, 512, 1024):
        # a diagonal block of the recursion: a view with a longer row
        buf = torch.zeros(n, 2 * n, device="cuda")
        blk = buf[:, n // 2:n // 2 + n]
        blk.copy_(spd(gen, n))
        A0 = blk.clone()
        want = A0.clone()
        i_ref = potrf_block_plain(want)
        info = potrf_block_f32(blk)
        require(int(info) == 0 and int(i_ref) == 0,
                f"potrf_block_f32 n={n}: info {int(info)}/{int(i_ref)}")
        err = max_err(blk, want)
        b = bound(8 * n, float(want.abs().max()))
        require(err <= b, f"potrf_block_f32 n={n}: err {err} > {b}")
        require(bool((torch.triu(blk, 1) == 0).all()),
                f"potrf_block_f32 n={n}: strict upper not zero")
        require(bool((buf[:, :n // 2] == 0).all()
                     and (buf[:, n // 2 + n:] == 0).all()),
                f"potrf_block_f32 n={n}: wrote outside the view")
        ms = bench_op(lambda a: potrf_block_f32(a.clone()), A0) * 1e3
        plain_ms = bench_op(lambda a: potrf_block_plain(a.clone()), A0,
                            warmup=1, reps=3) * 1e3
        print(f"potrf_block_f32 n={n}: max err {err:.3e} (bound {b:.3e}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms on {on}")
        if n == 1024:
            rec["potrf_block_f32"] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms)
    # non-PD pivot: info 5, everything finite, the leading block right
    A = spd(gen, 256, 10.0)
    A[4, 4] = -1.0
    want = A.clone()
    i_ref = potrf_block_plain(want)
    info = potrf_block_f32(A)
    require(int(info) == 5 == int(i_ref), f"non-PD info {int(info)}")
    require(bool(torch.isfinite(A).all()), "non-PD output not finite")
    require(max_err(A[:4, :4], want[:4, :4]) <= bound(8 * 4, 10.0),
            "non-PD leading block")
    # NaN pivot: info 8, only (7, 7) non-finite; the strict upper unread
    A = spd(gen, 256, 10.0)
    A[7, 7] = float("nan")
    A[torch.ones_like(A, dtype=torch.bool).triu(1)] = float("nan")
    info = potrf_block_f32(A)
    bad = (~torch.isfinite(A)).nonzero().tolist()
    require(int(info) == 8 and all(ix == [7, 7] for ix in bad),
            f"NaN pivot: info {int(info)}, non-finite at {bad[:5]}")
    print("potrf_block_f32 non-PD A[4,4]=-1: info 5, finite; NaN pivot "
          "A[7,7]: info 8, nothing but (7,7) non-finite, strict upper unread")


def check_trtri_block(gen, rec, on):
    for n in (128, 512):
        L = spd(gen, n)
        require(int(potrf_block_f32(L)) == 0, "trtri input factor")
        W, info = trtri_block_f32(L)
        want, i_ref = trtri_block_plain(L)
        require(int(info) == 0 == int(i_ref), f"trtri n={n}: info")
        err = max_err(W, want)
        b = bound(60 * n, float(want.abs().max()))
        require(err <= b, f"trtri_block_f32 n={n}: err {err} > {b}")
        require(bool((torch.triu(W, 1) == 0).all()), "trtri strict upper")
        ms = bench_op(lambda x: trtri_block_f32(x), L) * 1e3
        plain_ms = bench_op(lambda x: trtri_block_plain(x), L, warmup=1,
                            reps=3) * 1e3
        print(f"trtri_block_f32 n={n}: max err {err:.3e} (bound {b:.3e}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms on {on}")
        if n == 512:
            rec["trtri_block_f32"] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms)
    # zero diagonal: info 10, treated as 1, output finite
    L = torch.tril(torch.rand(256, 256, device="cuda", generator=gen)) / 256
    L.diagonal().fill_(1.0)
    L[9, 9] = 0.0
    W, info = trtri_block_f32(L)
    require(int(info) == 10 and bool(torch.isfinite(W).all()),
            f"zero diagonal: info {int(info)}")
    print("trtri_block_f32 zero diagonal L[9,9]=0: info 10, finite")


# ---------------------------------------------------------------------------
# phase 4: the main path through the public API
# ---------------------------------------------------------------------------

def backward_error(F, A, uplo="L"):
    L = torch.tril(F) if uplo == "L" else torch.triu(F).T
    L = L.double()
    return float((L @ L.T - A.double()).abs().max())


def main_path(gen, name_power):
    inputs = {n: spd(gen, n) for n in (4096, 8192)}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = {n: (ct.potrf("L", A), ct.logdet("L", A))
           for n, A in inputs.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"main path launches: {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path was not launched: {launches}")
    for n, ((F, info), (ld, info2)) in out.items():
        A = inputs[n]
        require(int(info) == 0 and int(info2) == 0,
                f"potrf n={n}: info {int(info)}, logdet info {int(info2)}")
        be = backward_error(F, A)
        b = bound(n, float(A.abs().max()))
        require(be <= b, f"potrf n={n}: backward error {be} > {b}")
        ref = float(torch.linalg.slogdet(A.double())[1])
        rel = abs(float(ld) - ref) / abs(ref)
        require(rel <= n * EPS32, f"logdet n={n}: rel err {rel}")
        print(f"spotrf n={n}: info 0, max|LLᵀ-A| {be:.3e} (bound {b:.3e}); "
              f"logdet {float(ld):.6f} vs f64 slogdet {ref:.6f}, rel err "
              f"{rel:.3e} (bound n·eps {n * EPS32:.3e})")
    del out
    # upper at n = 1024 (the whole-block route)
    A = spd(gen, 1024)
    F, info = ct.potrf("U", A)
    be = backward_error(F, A, "U")
    require(int(info) == 0 and be <= bound(1024, float(A.abs().max())),
            f"potrf U n=1024: info {int(info)}, backward error {be}")
    print(f"spotrf U n=1024: info 0, max|UᵀU-A| {be:.3e}")
    # non-PD at n = 4096: the first bad pivot, and the leading block right
    A = inputs[4096].clone()
    A[3000, 3000] = -1.0
    F, info = ct.potrf("L", A)
    require(int(info) == 3001, f"non-PD n=4096: info {int(info)} != 3001")
    be = backward_error(F[:3000, :3000], A[:3000, :3000])
    require(be <= bound(4096, float(A.abs().max())),
            f"non-PD leading block: backward error {be}")
    print(f"spotrf non-PD n=4096 A[3000,3000]=-1: info 3001, leading "
          f"3000 block max|LLᵀ-A| {be:.3e}")
    # rates, beside torch.linalg.cholesky (oracle and yardstick)
    for n, A in inputs.items():
        t = bench_op(lambda a: ct.potrf("L", a), A, reps=5)
        t_ref = bench_op(lambda a: torch.linalg.cholesky(a), A, reps=5)
        print(f"spotrf n={n}: port {flops_potrf(n) / t / 1e9:.1f} GF/s "
              f"({t * 1e3:.3f} ms), torch.linalg.cholesky "
              f"{flops_potrf(n) / t_ref / 1e9:.1f} GF/s ({t_ref * 1e3:.3f} "
              f"ms) on {name_power}")
    return launches


SOURCES = {
    "gemm_f32": ("cholesky_tpu_torch/ops/kernels/csrc/gemm.cu",
                 "cholesky_tpu/ops/pallas/gemm.py:64"),
    "syrk_lower_f32": ("cholesky_tpu_torch/ops/kernels/csrc/syrk.cu",
                       "cholesky_tpu/ops/pallas/syrk.py:70"),
    "potrf_block_f32": ("cholesky_tpu_torch/ops/kernels/csrc/potrf_block.cu",
                        "cholesky_tpu/ops/pallas/mega.py:234"),
    "trtri_block_f32": ("cholesky_tpu_torch/ops/kernels/csrc/trtri_block.cu",
                        "cholesky_tpu/ops/pallas/mega.py:519"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # 1. device and environment
    name_power = card()
    print(name_power)           # exactly as nvidia-smi gives it
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    print(f"TF32: matmul {tf32[0]}, cudnn {tf32[1]}, float32 matmul "
          f"precision {torch.get_float32_matmul_precision()}")
    require(tf32 == (False, False), "TF32 must be off")

    # 2. build
    b = _build.build()
    print(f"build: nvcc {b.seconds:.1f} s -> {b.path} (on the host of "
          f"{name_power})")
    for line in b.log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels against their twins
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    check_gemm(gen, rec, name_power)
    check_syrk(gen, rec, name_power)
    check_potrf_block(gen, rec, name_power)
    check_trtri_block(gen, rec, name_power)

    # 4. main path
    launches = main_path(gen, name_power)
    require("jax" not in sys.modules, "jax was imported")

    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k], **rec[k])
               for k in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
