#!/usr/bin/env python3
"""Time the port's leaf kernels and the GP step of one checkout on the card.

    python3 chip_compare.py [--tree DIR] [TAG]
    python3 chip_compare.py [--tree DIR] --fills [TAG]
    python3 chip_compare.py [--tree DIR] --paths [TAG]

Imports ``cholesky_tpu_torch`` from DIR (default: this script's checkout),
so that two trees, for example a change and its parent unpacked with
``git archive``, can be timed in one call in turns (parent, change,
change, parent) on the same card. It measures what ``chip_smoke.py``
does not measure in an older tree, each time beside one PyTorch call of
the same function, and each kernel's device time under torch.profiler by
CUDA kernel name, with its launches (names as the tree's sources give
them, so two trees' splits can differ):

- ``trtri_block_f32`` at n = 128, 512 and 1024 beside
  ``torch.linalg.solve_triangular(L, I)``;
- ``trti2_f32`` at n = 1024, 4096 and 8192, unit and not, beside
  ``solve_triangular(L, I)`` (``unitriangular`` for the unit form);
- ``syrk_lower_f32`` at n = k = 512, 1024, 2048 (the potrf recursion's
  shapes) and 8192, A and C views of one buffer, beside ``torch.addmm``
  on the whole square;
- the device time of every ``syrk_lower_f32`` launch of
  ``potrf(block_size=512)`` at 4096 and of ``lauum(block_size=512)`` at
  2048;
- ``potf2_f32`` at 4096, 8192 and 16384 beside ``torch.linalg.cholesky_ex``;
- ``trtri_stream_f32`` and ``lauum_stream_f32``, potri's two whole-matrix
  kernels, at n = 2048, 4096 and 8192 beside ``solve_triangular(L, I)``
  and ``trti2_f32`` on the same factor, and ``torch.matmul(Lᵀ, L)``; where
  the tree's ``trtri_stream_f32`` takes ``trace=``, one traced launch's
  phases (µs from block 0's entry to the last block's end, and to the
  next phase's entry);
- ``lauu2_f32`` at n = 128, 368, 512, 1000 and 2048: ms of one call, the
  host's ms to enqueue it, its kernels' device time by name, beside
  ``torch.matmul(Lᵀ, L)``, at 2048 in turns with ``lauum_stream_f32`` on
  the same L; and ``lauum(block_size=512)`` at 2048,
  ``lauum(block_size=2048)`` at 4096, ``potri`` at 512 and 6000, each
  with its ``lauu2_f32`` launches and the device time of the lauum
  kernels by name;
- one GP train step at n = 8192, d = 8 (as in ``chip_smoke.py`` phase 5)
  with the ``trtri_block_f32``, ``trtri_stream_f32`` and
  ``lauum_stream_f32`` launches it makes and their device time.

With ``--fills`` it times only the device fills at 8192², each in a
process of its own (``--fill NAME`` runs one), so that no earlier work
shapes the reading: ``uniform_fill_f64`` and ``uniform_fill_f32`` (the
tree's kernels, from the seeds ``chip_smoke.py`` gives them) and
``torch.rand`` in f64 and f32 on a CUDA generator. Each reading gives
the CUDA-event time of one call (FILL_REPS calls: median, min, max) and
the device time of each launch under torch.profiler (FILL_REPS launches:
median, 10th and 90th percentile, and the kernels' names).

With ``--paths`` it times only the public paths that the tuning table
routes, under the table in force in DIR (its path, or DEFAULTS, is in the
line): the GP train step at n = 8192, d = 8 (host clock, a synchronize
after each step), spotrf at 1024, 4096, 8192 and 16384, ``strtri`` at
8192 with and without ``block_size=8192``, ``strsm`` of one column at
8192, ``potri`` at 4096 and 6000, ``cpotri`` at 4096, ``dpotrf`` at 4096
and 6144 and ``dpotri`` at 4096 (CUDA events around one call), each as
[median, min, max] ms of PATH_REPS calls with the launches of one call
by kernel.

Prints the card's name and power limit, then one JSON line. Needs one
CUDA card.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import subprocess
import sys
import time


def kernel_name(name: str) -> str:
    """A CUDA kernel's name as the profiler shows it, without its return
    type, namespaces and parameters (``potf2_update128<true>``)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].rsplit("::", 1)[-1]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


FILL_N = 8192
FILL_REPS = 30
FILLS = ("uniform_fill_f64", "torch.rand f64", "uniform_fill_f32",
         "torch.rand f32")


def quantile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def fill_alone(name: str) -> dict:
    """One fill of FILL_N² timed in this process, after two warm-up
    calls: CUDA events around each of FILL_REPS calls, then the device
    time of each of FILL_REPS launches under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cholesky_tpu_torch.ops.kernels import prng
    from cholesky_tpu_torch.rng import device as rng_device

    n = FILL_N
    dtype = torch.float64 if name.endswith("f64") else torch.float32
    if name.startswith("torch.rand"):
        g = torch.Generator(device="cuda").manual_seed(0)

        def call():
            return torch.rand(n, n, generator=g, device="cuda", dtype=dtype)
    else:
        fill = getattr(prng, name)
        salt = rng_device.SALT_F64 if dtype == torch.float64 else 0
        seeds = rng_device._mix_seeds(11, n // 256, salt).cuda()

        def call():
            return fill(seeds, n, n)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(FILL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(FILL_REPS):
            call()
        torch.cuda.synchronize()
    dev, names = [], set()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.time_range.end - e.time_range.start) / 1e3)
            names.add(kernel_name(e.name))
    return {"ms": [quantile(times, 0.5), min(times), max(times)],
            "device ms": [quantile(dev, 0.5), quantile(dev, 0.1),
                          quantile(dev, 0.9)],
            "launches": len(dev), "kernels": sorted(names)}


PATH_REPS = 9


def gp_step(n=8192, d=8):
    """One GP train step of chip_smoke.py phase 5 (n points, d features,
    seed 1) on the package imported, as a function of no arguments."""
    import torch

    from cholesky_tpu_torch.models import gp

    gg = torch.Generator(device="cuda").manual_seed(1)
    X = torch.rand(n, d, device="cuda", generator=gg) * 2.0 - 1.0
    w = torch.randn(d, device="cuda", generator=gg)
    y = torch.sin(3.0 * X @ w / math.sqrt(d)) + 0.1 * torch.randn(
        n, device="cuda", generator=gg)
    p0 = gp.GPParams.init(device="cuda")
    _, g0, _ = gp.gp_nll_and_grads(p0, X, y)
    lr = 0.05 / max(abs(float(v)) for v in g0)
    return lambda: gp.gp_train_step(p0, X, y, lr=lr)


def public_paths(tree: str, tag: str) -> int:
    """The table-routed public paths of the package at ``tree``."""
    import torch

    import cholesky_tpu_torch as ct
    from cholesky_tpu_torch.ops import kernels
    from cholesky_tpu_torch.rng import latmc
    from cholesky_tpu_torch.tuning import table

    print(card())
    path = table.table_path(torch.cuda.get_device_name(0))
    out = {"tree": tree, "tag": tag,
           "table": str(path) if path.exists() else "DEFAULTS"}
    g = torch.Generator(device="cuda").manual_seed(0)

    def summary(times):
        times = sorted(times)
        return [times[len(times) // 2], times[0], times[-1]]

    def launches(fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return {k: v for k, v in kernels.launch_counts().items() if v}

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(PATH_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = {"ms": summary(times), "launches": launches(fn)}

    def factor(n, dtype=torch.float32):
        F, info = ct.potrf("L", latmc(g, n, 100.0, dtype))
        if int(info):
            raise RuntimeError(f"factor n={n}: info {int(info)}")
        return torch.tril(F)

    for n in (1024, 4096, 8192, 16384):
        A = latmc(g, n, 100.0, torch.float32)
        timed(f"spotrf {n}", lambda: ct.potrf("L", A))
        del A
    L = factor(8192)
    timed("strtri 8192", lambda: ct.strtri("L", "N", L))
    timed("strtri 8192 block_size=8192",
          lambda: ct.strtri("L", "N", L, block_size=8192))
    b = torch.randn(8192, 1, device="cuda", generator=g)
    timed("strsm 8192 x 1", lambda: ct.strsm("L", "L", "N", "N", 1.0, L, b))
    del L
    for n in (4096, 6000):
        L = factor(n)
        timed(f"spotri {n}", lambda: ct.spotri("L", L))
        del L
    Lc = factor(4096, torch.complex64)
    timed("cpotri 4096", lambda: ct.cpotri("L", Lc))
    del Lc
    # the d tier (host-bound): the hoisted peel or not, as the table's
    # ozaki_f64.hoist_min_n decides per call
    for n in (4096, 6144):
        A = latmc(g, n, 100.0, torch.float64)
        timed(f"dpotrf {n}", lambda: ct.dpotrf("L", A))
        del A
    Ld = factor(4096, torch.float64)
    timed("dpotri 4096", lambda: ct.dpotri("L", Ld))
    del Ld

    step = gp_step()
    step()
    times = []
    for _ in range(PATH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["GP step 8192"] = {"ms": summary(times), "launches": launches(step)}
    print(json.dumps(out))
    return 0


def fills(tree: str, tag: str) -> int:
    """Each of FILLS alone in a fresh process of this script."""
    print(card())
    out = {"tree": tree, "tag": tag}
    for name in FILLS:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree, "--fill", name],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        out[name] = json.loads(run.stdout.strip().splitlines()[-1])
    print(json.dumps(out))
    return 0


def main() -> int:
    args = sys.argv[1:]
    tree = os.path.dirname(os.path.abspath(__file__))
    if args[:1] == ["--tree"]:
        tree, args = os.path.abspath(args[1]), args[2:]
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    if args[:1] == ["--fills"]:
        return fills(tree, args[1] if len(args) > 1 else "")
    if args[:1] == ["--fill"]:
        print(json.dumps(fill_alone(args[1])))
        return 0
    if args[:1] == ["--paths"]:
        return public_paths(tree, args[1] if len(args) > 1 else "")
    import cholesky_tpu_torch  # noqa: F401  (TF32 off)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cholesky_tpu_torch.ops.kernels import (lauum_stream_f32, mega,
                                                potf2_f32, syrk_lower_f32,
                                                trti2_f32, trtri_block_f32,
                                                trtri_stream_f32)
    from cholesky_tpu_torch.utils.benchlib import bench_op

    print(card())
    g = torch.Generator(device="cuda").manual_seed(0)

    def dense_spd(n):
        G = torch.randn(n, n, device="cuda", generator=g)
        A = torch.matmul(G, G.T).div_(n)
        A.diagonal().add_(4.0 / 99.0)
        return 0.5 * (A + A.T)

    def ms_inplace(fn, A, reps):
        copies = [A.clone() for _ in range(reps + 1)]
        fn(copies.pop())
        times = []
        for X in copies:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(X)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    def device_by_kernel(fn, match):
        """fn() under torch.profiler: {kernel: [device ms, launches]} for
        the CUDA kernels whose name holds ``match``, and under "busy" the
        union of their intervals (kernels that overlap, as a launch
        scheduled early by programmatic dependent launch waits inside its
        predecessor's run, count once)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        split, spans = {}, []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and match in e.name:
                row = split.setdefault(kernel_name(e.name), [0.0, 0])
                row[0] += (e.time_range.end - e.time_range.start) / 1e3
                row[1] += 1
                spans.append((e.time_range.start, e.time_range.end))
        busy, last = 0.0, -math.inf
        for a, b in sorted(spans):
            if b > last:
                busy += b - max(a, last)
                last = b
        split["busy"] = [busy / 1e3, len(spans)]
        return split

    def trtri_device_ms(fn):
        """fn() under torch.profiler: its trtri_block_f32 kernels' device
        ms and the launches it made."""
        before = trtri_block_f32.launches
        split = device_by_kernel(fn, "trtri_block")
        return split["busy"][0], trtri_block_f32.launches - before

    def per_call(split, calls):
        return {k: [ms / calls, c / calls] for k, (ms, c) in split.items()}

    out = {"tree": tree, "tag": args[0] if args else ""}
    for n in (128, 512, 1024):
        L = torch.linalg.cholesky(dense_spd(n)).contiguous()
        eye = torch.eye(n, device="cuda")
        out[f"trtri_block_f32 {n}"] = bench_op(
            lambda x: trtri_block_f32(x), L, reps=50) * 1e3
        ms, calls = trtri_device_ms(
            lambda: [trtri_block_f32(L) for _ in range(20)])
        out[f"trtri_block_f32 {n} device"] = ms / calls
        out[f"solve_triangular {n}"] = bench_op(
            lambda x: torch.linalg.solve_triangular(x, eye, upper=False), L,
            reps=50) * 1e3
    for n in (1024, 4096, 8192):
        L = torch.linalg.cholesky(dense_spd(n)).contiguous()
        eye = torch.eye(n, device="cuda")
        reps = 20 if n < 8192 else 5
        for unit in (False, True):
            tag = f"trti2_f32 {n}{' unit' if unit else ''}"
            out[tag] = bench_op(lambda x: trti2_f32(x, unit=unit), L,
                                reps=reps) * 1e3
            out[f"{tag} device"] = per_call(device_by_kernel(
                lambda: [trti2_f32(L, unit=unit) for _ in range(3)],
                "trti2"), 3)
            out[f"solve_triangular {n}{' unit' if unit else ''}"] = \
                bench_op(lambda x: torch.linalg.solve_triangular(
                    x, eye, upper=False, unitriangular=unit), L,
                    reps=reps) * 1e3
        del L, eye
    for n in (512, 1024, 2048, 8192):
        # A and C views of one buffer, as L21 and A22 of the recursion
        buf = torch.randn(n, 2 * n, device="cuda", generator=g)
        A, C = buf[:, :n], buf[:, n:]
        reps = 20 if n < 8192 else 5
        out[f"syrk_lower_f32 {n}"] = bench_op(
            lambda c: syrk_lower_f32(-1e-3, A, 1.0, c), C, reps=reps) * 1e3
        out[f"syrk_lower_f32 {n} device"] = per_call(device_by_kernel(
            lambda: [syrk_lower_f32(-1e-3, A, 1.0, C) for _ in range(5)],
            "syrk"), 5)
        out[f"addmm {n}"] = bench_op(lambda c: torch.addmm(
            c, A, A.T, beta=1.0, alpha=-1e-3), C, reps=reps) * 1e3
        del buf, A, C
    for what, n, call in (("potrf", 4096, cholesky_tpu_torch.potrf),
                          ("lauum", 2048, cholesky_tpu_torch.lauum)):
        A = dense_spd(n)
        if what == "lauum":
            A = torch.linalg.cholesky(A)
        call("L", A, block_size=512)
        before = syrk_lower_f32.launches
        split = device_by_kernel(lambda: call("L", A, block_size=512),
                                 "syrk")
        out[f"{what} {n} block_size=512 syrk device"] = {
            "launches": syrk_lower_f32.launches - before,
            "ms": split.pop("busy")[0], "kernels": split}
        del A
    for n in (4096, 8192, 16384):
        A = dense_spd(n)
        out[f"potf2_f32 {n}"] = ms_inplace(potf2_f32, A, 3)
        out[f"cholesky_ex {n}"] = ms_inplace(torch.linalg.cholesky_ex, A, 3)
        del A
    traced = "trace" in inspect.signature(trtri_stream_f32).parameters
    for n in (2048, 4096, 8192):
        L = torch.linalg.cholesky(dense_spd(n)).contiguous()
        eye = torch.eye(n, device="cuda")
        reps = 20 if n < 8192 else 5
        # in turns: trtri_stream_f32, trti2_f32, trti2_f32, trtri_stream_f32
        t = [bench_op(fn, L, reps=reps) * 1e3 for fn in (
            trtri_stream_f32, trti2_f32, trti2_f32, trtri_stream_f32)]
        out[f"trtri_stream_f32 {n}"] = [t[0], t[3]]
        out[f"trti2_f32 {n} same factor"] = [t[1], t[2]]
        out[f"trtri_stream_f32 {n} device"] = per_call(device_by_kernel(
            lambda: [trtri_stream_f32(L) for _ in range(3)],
            "trtri_stream"), 3)
        out[f"solve_triangular {n} stream factor"] = bench_op(
            lambda x: torch.linalg.solve_triangular(x, eye, upper=False), L,
            reps=reps) * 1e3
        if traced:
            trtri_stream_f32(L)
            names = mega.trtri_stream_phases(n)
            tr = torch.zeros(len(names), mega.TRTRI_TRACE_SLOTS,
                             dtype=torch.int64, device="cuda")
            torch.cuda.synchronize()
            trtri_stream_f32(L, trace=tr)
            tr = (tr.cpu() - int(tr[0, 0])).double() / 1e3
            nxt = list(tr[1:, 0]) + [tr[-1, 1]]
            out[f"trtri_stream_f32 {n} trace"] = {
                name: [float(tr[i, 1] - tr[i, 0]), float(nxt[i] - tr[i, 0])]
                for i, name in enumerate(names)}
        out[f"lauum_stream_f32 {n}"] = bench_op(
            lambda x: lauum_stream_f32(x), L, reps=reps) * 1e3
        out[f"lauum_stream_f32 {n} device"] = per_call(device_by_kernel(
            lambda: [lauum_stream_f32(L) for _ in range(3)], "lauum"), 3)
        out[f"matmul LtL {n}"] = bench_op(lambda x: torch.matmul(x.T, x), L,
                                          reps=reps) * 1e3
        del L, eye

    # lauu2_f32: call, host enqueue and device ms by kernel name (the PR
    # 10 tree's 64 x 64 kernel or the 128-tile launches), beside
    # torch.matmul(Lᵀ, L) and, at 2048, lauum_stream_f32 on the same L
    from cholesky_tpu_torch.ops.kernels import lauu2_f32

    def host_ms(fn, reps=20):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return sorted(times)[reps // 2]

    for n in (128, 368, 512, 1000, 2048):
        L = torch.tril(torch.linalg.cholesky(dense_spd(n)))
        out[f"lauu2_f32 {n}"] = bench_op(lambda x: lauu2_f32(x), L,
                                         reps=20) * 1e3
        out[f"lauu2_f32 {n} host"] = host_ms(lambda: lauu2_f32(L))
        out[f"lauu2_f32 {n} device"] = per_call(device_by_kernel(
            lambda: [lauu2_f32(L) for _ in range(10)], "lau"), 10)
        out[f"matmul LtL {n}"] = bench_op(lambda x: torch.matmul(x.T, x), L,
                                          reps=20) * 1e3
        if n == 2048:
            t = [bench_op(fn, L, reps=20) * 1e3 for fn in (
                lauu2_f32, lauum_stream_f32, lauum_stream_f32, lauu2_f32)]
            out[f"lauu2_f32 {n} in turns"] = [t[0], t[3]]
            out[f"lauum_stream_f32 {n} same L"] = [t[1], t[2]]
        del L
    # the paths that reach lauu2_f32 (or, potri at 6000, do not): call ms,
    # its launches and the device time of every lauum kernel by name
    for what, n, bs in (("lauum", 2048, 512), ("lauum", 4096, 2048),
                        ("potri", 512, None), ("potri", 6000, None)):
        L = torch.tril(torch.linalg.cholesky(dense_spd(n)))
        call = getattr(cholesky_tpu_torch, what)

        def path():
            return call("L", L, block_size=bs)
        path()
        before = lauu2_f32.launches
        split = device_by_kernel(path, "lau")
        out[f"{what} {n} block_size={bs} lauu2"] = {
            "launches": lauu2_f32.launches - before,
            "ms": bench_op(lambda _: path(), L, reps=10) * 1e3,
            "lau device ms": split.pop("busy")[0], "kernels": split}
        del L

    step = gp_step()
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["GP step"] = sorted(times)[2]
    ms, calls = trtri_device_ms(step)
    out["GP trtri_block_f32 launches"] = calls
    out["GP trtri_block_f32 device ms"] = ms
    for name, fn, match in (("trtri_stream_f32", trtri_stream_f32,
                             "trtri_stream"),
                            ("lauum_stream_f32", lauum_stream_f32, "lauum")):
        before = fn.launches
        split = device_by_kernel(step, match)
        out[f"GP {name}"] = {"launches": fn.launches - before,
                             "ms": split.pop("busy")[0], "kernels": split}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
