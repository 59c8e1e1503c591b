"""The port's minibench, report and golden-run tools
(cholesky_tpu_torch/tools): minibench refuses a machine without a card,
its flop_word is tools/minibench.py's arithmetic, report renders a golden
file (plain and --md) and the committed H100 goldens, and the golden
run's point set is the JAX record's (op, config, n) under its caps."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cholesky_tpu_torch.tools import goldens, minibench, report, sweep
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def test_minibench_without_a_card_prints_no_json():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    # 5-13 s in the suite under six workers
    out = subprocess.run([sys.executable, "-m",
                          "cholesky_tpu_torch.tools.minibench"], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("tflops,gbps,want", [
    (50.0, 3000.0, 66.7),       # 50e12 flop/s over 750e9 words/s
    (42.08, 2800.0, 60.1),
    (1.0, 4.0, 1000.0),
])
def test_flop_word(tflops, gbps, want):
    # tools/minibench.py: round(tflops * 1e3 / (gbps / 4), 1)
    assert minibench.flop_word(tflops, gbps) == want
    assert minibench.flop_word(tflops, gbps) == round(
        tflops * 1e3 / (gbps / 4), 1)


def _row(op, n, gflops, passed=True, config=None, err=0.0):
    return {"op": op, "dtype": "s", "config": config or
            sweep.DEFAULT_CFG[op], "backend": "auto", "n": n,
            "time_ms": 1.0, "gflops": gflops, "info": 0, "max_err": err,
            "tol": 0.5, "passed": passed, "card": CARD}


@pytest.fixture
def golden_dir(tmp_path):
    rows = [_row("potrf", 1024, 3500.0, err=0.01234),
            _row("potrf", 4096, 8750.0, err=0.1),
            _row("potrf", 2048, 9000.0, passed=False, err=0.75),
            _row("gemm", 1024, 20750.0),
            {"op": "gemm", "dtype": "s", "config": "nn", "n": 512,
             "passed": False, "error": "RuntimeError", "card": CARD},
            _row("logdet_diag", 4096, 12.5)]
    (tmp_path / "golden_h100_s.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    return tmp_path


def test_report_plain(golden_dir, capsys):
    assert report.main(["--dir", str(golden_dir)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"cards": [CARD]}
    by_op = {r["op"]: r for r in lines[1:]}
    assert set(by_op) == {"potrf", "gemm", "logdet_diag"}
    # the best row by GF/s, failed or not, with the op's points and fails
    assert by_op["potrf"] == {"dtype": "s", "op": "potrf",
                              "best_gflops": 9000.0, "at_n": 2048,
                              "config": "l", "points": 3, "failed": 1,
                              "worst_err_tol": 1.5,
                              "vs_ref": "51.4x s-ref"}
    assert by_op["gemm"]["points"] == 2 and by_op["gemm"]["failed"] == 1
    # the row without a score (an error) has no ratio
    assert by_op["gemm"]["worst_err_tol"] == 0.0
    assert by_op["gemm"]["vs_ref"] == "50.0x s-ref"
    assert by_op["logdet_diag"]["vs_ref"] == "-"


def test_report_md(golden_dir, capsys):
    assert report.main(["--dir", str(golden_dir), "--md"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"Card: {CARD} ")
    assert out[2].startswith("| dtype | op | best GF/s |")
    assert out[4:] == [
        "| s | gemm | 20750.0 | 1024 | nn | 2 (1) | 0.0 | 50.0x s-ref |",
        "| s | logdet_diag | 12.5 | 4096 | auto | 1 (0) | 0.0 | - |",
        "| s | potrf | 9000.0 | 2048 | l | 3 (1) | 1.5 | 51.4x s-ref |"]


def test_report_renders_the_committed_goldens(capsys):
    assert report.main(["--dir", str(REPO / "bench_results"), "--md"]) == 0
    out = capsys.readouterr().out.splitlines()
    body = [ln for ln in out if ln.startswith("| ") and "dtype" not in ln]
    pairs = set()
    for letter in "sdcz":
        rows = report.load(REPO / "bench_results"
                           / report.GOLDEN.format(letter))
        assert rows and all(r["card"] == rows[0]["card"] for r in rows)
        pairs |= {(letter, r["op"]) for r in rows}
    assert len(body) == len(pairs)
    assert "H100" in out[0]


@pytest.mark.parametrize("letter,groups,points", [
    ("s", 41, 232), ("d", 25, 111), ("c", 30, 150), ("z", 24, 131)])
def test_golden_point_sets(letter, groups, points):
    path = REPO / "bench_results" / f"golden_tpu_v5_lite_{letter}.jsonl"
    sets = goldens.point_set(path, goldens.CAP[letter])
    assert (len(sets), sum(len(v) for v in sets.values())) == (groups,
                                                              points)
    assert all(n <= goldens.CAP[letter] for v in sets.values() for n in v)
    tpu = {sweep.row_key(r) for r in sweep.load_rows(path)
           if r["n"] <= goldens.CAP[letter]}
    assert tpu == {(op, letter, cfg, n) for (op, cfg), ns in sets.items()
                   for n in ns}


def test_committed_goldens_cover_the_point_sets():
    for letter in "sdcz":
        sets = goldens.point_set(
            REPO / "bench_results" / f"golden_tpu_v5_lite_{letter}.jsonl",
            goldens.CAP[letter])
        want = {(op, letter, cfg, n) for (op, cfg), ns in sets.items()
                for n in ns}
        rows = sweep.load_rows(REPO / "bench_results"
                               / f"golden_h100_{letter}.jsonl")
        assert {sweep.row_key(r) for r in rows} == want
        assert len(rows) == len(want)
        assert all("H100" in r["card"] for r in rows)
