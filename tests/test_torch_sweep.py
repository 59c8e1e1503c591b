"""The port's sweep (cholesky_tpu_torch/tools/sweep.py) against the JAX
harness tools/sweep.py: the same variant tables, config normalization and
tolerances; then in-process --cpu runs of all eleven ops in s/d/c/z with
the JAX row's keys plus ``card``, --resume, --golden (a slower row, a file
whose rows name no card), an oracle that fails, the oracle workers' slots,
the refusal to run without a card, and no timed call beside an oracle."""

import importlib.util
import json
import sys
import time
from pathlib import Path

import jax
import pytest
import torch

from cholesky_tpu_torch.runtime import TaskPool
from cholesky_tpu_torch.tools import sweep
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ALL_OPS = ",".join(sweep.POINTS)
JAX_ROW_KEYS = {"op", "dtype", "config", "backend", "n", "time_ms", "gflops",
                "info", "max_err", "tol", "passed"}


def _load_jax_sweep():
    """tools/sweep.py loaded by its path, as tests/test_sweep_harness.py
    loads it (JAX imported, nothing compiled), with the compilation-cache
    setting it makes at import put back."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "jax_tools_sweep", REPO / "tools" / "sweep.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


jsweep = _load_jax_sweep()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU sweep's torch ops on one thread: beside other test workers
    on the host, torch's intra-op threads oversubscribe the cores and the
    sweeps take many times their time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(tmp_path, *args, name="out.jsonl"):
    out = tmp_path / name
    rc = sweep.main(["--cpu", "--max-chain", "1", "--out", str(out), *args])
    rows = sweep.load_rows(out) if out.exists() else []
    return rc, rows


def test_tables_equal_the_jax_harness():
    assert sweep.DEFAULT_CFG == jsweep.DEFAULT_CFG
    assert sweep.GRID_CFG == jsweep.GRID_CFG
    assert list(sweep.POINTS) == list(jsweep.POINTS)


@pytest.mark.parametrize("op,cfg", [
    ("potrf", "auto"), ("trmm", "auto"), ("trtri", None), ("potrf", "u"),
    ("trsm", "rutn"), ("gemm", "zz"), ("logdet_diag", "auto"),
    ("syrk", "ut"), ("gemm_k", "tn"), ("lauum", "x"),
])
def test_norm_cfg_equals_the_jax_harness(op, cfg):
    assert sweep.norm_cfg(op, cfg) == jsweep.norm_cfg(op, cfg)


@pytest.mark.parametrize("letter", "sdcz")
def test_tol_equals_the_jax_harness(letter):
    jdt = jsweep.DT(letter)            # on the CPU: no Ozaki fudge
    for device, fudge in (("cpu", 1.0),
                          ("cuda", 16.0 if letter in "dz" else 1.0)):
        dt = sweep.DT(letter, device)
        assert (dt.eps, dt.flop_factor, dt.fudge) == (jdt.eps,
                                                      jdt.flop_factor, fudge)
        jdt.fudge = fudge              # the TPU's Ozaki tiers: 16
        for fpe in (3, 195, 6400, 300000):
            for scale in (0.25, 1.0, 37.5):
                for n in (0, 64, 1024, 8192):
                    assert sweep._tol(dt, fpe, scale, n) == \
                        jsweep._tol(jdt, fpe, scale, n)


@pytest.mark.parametrize("letter", "sdcz")
def test_cpu_run_of_every_op(tmp_path, letter, capsys):
    # the default --ops is every point; each scored row is also printed
    rc, rows = run(tmp_path, "--dtype", letter, "--sizes", "64,96")
    assert rc == 0
    assert [json.loads(x) for x in
            capsys.readouterr().out.splitlines()] == rows
    assert [(r["op"], r["n"]) for r in rows] == [
        (op, n) for op in sweep.POINTS for n in (64, 96)]
    for r in rows:
        assert set(r) == JAX_ROW_KEYS | {"card"}, r
        assert r["passed"] and r["info"] == 0 and r["card"] == "cpu", r
        assert r["dtype"] == letter and r["config"] == \
            sweep.DEFAULT_CFG[r["op"]]
        assert r["max_err"] <= r["tol"]


def test_cpu_grid_run(tmp_path):
    rc, rows = run(tmp_path, "--dtype", "s", "--ops", ALL_OPS, "--sizes",
                   "64", "--config", "grid")
    assert rc == 0
    assert [(r["op"], r["config"]) for r in rows] == [
        (op, cfg) for op, cfgs in sweep.GRID_CFG.items() for cfg in cfgs]
    assert all(r["passed"] for r in rows)


def counting(monkeypatch, op):
    calls = []
    real = sweep.POINTS[op]

    def point(n, backend, dt, cfg):
        calls.append(n)
        return real(n, backend, dt, cfg)

    monkeypatch.setitem(sweep.POINTS, op, point)
    return calls


def test_resume_skips_done_points(tmp_path, monkeypatch):
    calls = counting(monkeypatch, "potrf")
    rc, first = run(tmp_path, "--ops", "potrf", "--sizes", "64")
    assert rc == 0 and calls == [64]
    rc, rows = run(tmp_path, "--ops", "potrf", "--sizes", "64,96",
                   "--resume")
    assert rc == 0 and calls == [64, 96]
    assert rows[0] == first[0] and [r["n"] for r in rows] == [64, 96]


def fixed_time(monkeypatch, sec=1e-3):
    """Every point timed at ``sec``: a comparison with a golden row then
    depends on the golden number only."""
    def timed(f, x, n, dt):
        return sec, f(x)

    monkeypatch.setattr(sweep, "_time", timed)


def write(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def test_golden_with_a_faster_row_exits_1(tmp_path, monkeypatch):
    fixed_time(monkeypatch)
    rc, rows = run(tmp_path, "--ops", "potrf,gemm", "--sizes", "64",
                   name="golden.jsonl")
    assert rc == 0
    same = write(tmp_path / "same.jsonl", rows)
    assert run(tmp_path, "--ops", "potrf,gemm", "--sizes", "64",
               "--golden", same)[0] == 0
    faster = [dict(r) for r in rows]
    faster[1]["gflops"] = rows[1]["gflops"] / 0.69    # ours 31 % slower
    assert run(tmp_path, "--ops", "potrf,gemm", "--sizes", "64", "--golden",
               write(tmp_path / "faster.jsonl", faster))[0] == 1
    # a golden row of another card is not compared
    other = [dict(r, card="NVIDIA H100 80GB HBM3, 700.00 W")
             for r in faster]
    assert run(tmp_path, "--ops", "potrf,gemm", "--sizes", "64", "--golden",
               write(tmp_path / "other.jsonl", other))[0] == 0


@pytest.mark.parametrize("golden", ["tpu", "one row"])
def test_golden_without_card_is_refused(tmp_path, golden):
    if golden == "tpu":
        path = str(REPO / "bench_results" / "golden_tpu_v5_lite_s.jsonl")
    else:
        rows = [{"op": "potrf", "dtype": "s", "config": "l", "n": 64,
                 "gflops": 1.0, "passed": True, "card": "cpu"},
                {"op": "gemm", "dtype": "s", "config": "nn", "n": 64,
                 "gflops": 1.0, "passed": True}]
        path = write(tmp_path / "mixed.jsonl", rows)
    rc, rows = run(tmp_path, "--ops", "potrf", "--sizes", "64",
                   "--golden", path)
    assert rc == 3 and rows == []


@pytest.mark.parametrize("fault", ["raises", "wrong"])
def test_failed_oracle_exits_2(tmp_path, monkeypatch, fault):
    real = sweep.POINTS["potrf"]

    def point(n, backend, dt, cfg):
        sec, flops, oracle, fpe, info = real(n, backend, dt, cfg)

        def bad():
            if fault == "raises":
                raise FloatingPointError("forced")
            return 1.0, 1.0

        return sec, flops, bad, fpe, info

    monkeypatch.setitem(sweep.POINTS, "potrf", point)
    rc, rows = run(tmp_path, "--ops", "potrf,gemm", "--sizes", "64")
    assert rc == 2
    assert [r["passed"] for r in rows] == [False, True]
    if fault == "raises":
        assert rows[0]["error"] == "oracle FloatingPointError"
    else:
        assert rows[0]["max_err"] > rows[0]["tol"]


def test_oracles_take_every_worker_in_turn(tmp_path, monkeypatch):
    slots = []

    class Recording(TaskPool):
        def run(self, worker, fn):
            slots.append(worker)
            return super().run(worker, fn)

    monkeypatch.setattr(sweep, "TaskPool", Recording)
    rc, rows = run(tmp_path, "--ops", "potrf,gemm,syrk", "--sizes",
                   "32,48,64")
    assert rc == 0 and len(rows) == 9
    # each oracle is drained before the next point: a slot taken from the
    # queue's length would put all nine on worker 0
    assert slots == [i % 4 for i in range(9)]


def test_no_timed_call_runs_beside_an_oracle(tmp_path, monkeypatch):
    running, beside = [0], []
    real_point, real_potrf = sweep.POINTS["potrf"], sweep.blocked.potrf

    def point(n, backend, dt, cfg):
        sec, flops, oracle, fpe, info = real_point(n, backend, dt, cfg)

        def slow():
            running[0] += 1
            try:
                time.sleep(0.05)
                return oracle()
            finally:
                running[0] -= 1

        return sec, flops, slow, fpe, info

    def potrf(*args, **kwargs):
        beside.append(running[0])
        return real_potrf(*args, **kwargs)

    monkeypatch.setitem(sweep.POINTS, "potrf", point)
    monkeypatch.setattr(sweep.blocked, "potrf", potrf)
    rc, rows = run(tmp_path, "--ops", "potrf", "--sizes", "32,48,64")
    assert rc == 0 and len(rows) == 3
    # every call of the op under test, the timed ones included, waited
    # for the previous points' oracles
    assert len(beside) >= 6 and beside == [0] * len(beside)


def test_no_card_and_no_cpu_writes_no_row(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = tmp_path / "rows.jsonl"
    assert sweep.main(["--ops", "potrf", "--sizes", "64", "--out",
                       str(out)]) != 0
    assert not out.exists()
    cli = __import__("subprocess").run(      # 4-6 s in the suite
        [sys.executable, "-m", "cholesky_tpu_torch.tools.sweep", "--sizes",
         "64", "--out", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=30)
    assert cli.returncode != 0 and not out.exists()
