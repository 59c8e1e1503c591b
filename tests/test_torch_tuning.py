"""The port's tuning layer and headline bench on the CPU: the H100's table
(its keys, its values through get_params, the routes _mega_ok takes under
it, beside the JAX package's _mega_ok under the same values), the
autotuner's decisions on made-up timings, and bench_torch.py's line."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cholesky_tpu.tuning
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu_torch.ops import blocked as tblocked
from cholesky_tpu_torch.ops.kernels import mega
from cholesky_tpu_torch.tuning import DEFAULTS, autotune, get_params, table

REPO = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
H100_TABLE = (REPO / "cholesky_tpu_torch" / "tuning" / "tables"
              / "nvidia_h100_80gb_hbm3.json")
OPS = ("potrf", "trtri", "lauum")


def h100_table() -> dict:
    return json.loads(H100_TABLE.read_text())


def h100_params(op, device_kind=None):
    return get_params(op, H100)


# ---------------------------------------------------------------------------
# the shipped table
# ---------------------------------------------------------------------------

def test_h100_table_keys_and_values():
    t = h100_table()
    assert set(t) <= set(DEFAULTS) | {"_meta"}, set(t)
    for op, params in t.items():
        if op == "_meta":
            continue
        extra = {k for k in params if op == "ozaki_f64"
                 and k.startswith("hoist_min_n_")}
        assert set(params) - extra <= set(DEFAULTS[op]), (op, params)
        for k, v in params.items():
            assert isinstance(v, int) and v > 0, (op, k, v)
        if "mega_max_n" in params:
            cap = params["mega_max_n"]
            assert cap % mega.NB == 0 and cap <= mega.STREAM_MAX_N, (op, cap)
    if "leaf_nb" in t.get("potrf_f32", {}):
        assert t["potrf_f32"]["leaf_nb"] % mega.NB == 0
    meta = t["_meta"]
    assert table._slug(meta["device_kind"]) == H100_TABLE.stem
    assert table.table_path(meta["device_kind"]) == H100_TABLE
    assert meta["device_kind"] == H100
    assert meta["power_limit"].endswith(" W")
    assert meta["card"] == f"{H100}, {meta['power_limit']}"


def test_get_params_reads_the_h100_table():
    t = h100_table()
    for op in DEFAULTS:
        assert get_params(op, H100) == {**DEFAULTS[op], **t.get(op, {})}, op


@pytest.mark.parametrize("op", OPS)
def test_mega_ok_follows_the_h100_table(op, monkeypatch):
    # with the table standing in for the card's, each op streams up to its
    # tuned cap, and the JAX package routes the same blocks under the same
    # values (its hard caps are the port's STREAM_MAX_N)
    monkeypatch.setattr(tblocked, "get_params", h100_params)
    monkeypatch.setattr(cholesky_tpu.tuning, "get_params", h100_params)
    cap = h100_params(f"{op}_f32")["mega_max_n"]
    for n in (100, 1024, 1025, 1152, 2048, 3072, 4096, 6000, 6144, 8192,
              8320):
        want = n <= mega.MAX_N and (n <= mega.NB or n % mega.NB == 0) or (
            n <= cap and n % mega.NB == 0)
        assert tblocked._mega_ok(n, op) == want, (op, n)
        assert tblocked._mega_ok(n, op) == jblocked._mega_ok(n, op), (op, n)


def test_trtri_at_8192_under_the_h100_table(monkeypatch):
    # the GP step's potri: one whole-matrix inverse at 8192 where the
    # table's trtri cap reaches it, and the working copy is then not padded
    monkeypatch.setattr(tblocked, "get_params", h100_params)
    whole = h100_params("trtri_f32")["mega_max_n"] >= 8192
    assert tblocked._mega_ok(8192, "trtri") == whole
    assert not tblocked._mega_ok(8000, "trtri")
    assert not tblocked._mega_ok(8320, "trtri")


def defaults_params(op, device_kind=None):
    return dict(DEFAULTS.get(op, {}))


@pytest.mark.parametrize("params,routes", [
    (defaults_params, {
        "strtri block_size=8192": {"trti2_f32"},
        "potri n=6000": {"gemm_f32", "trtri_stream_f32", "lauum_stream_f32"},
        "cpotri": {"gemm_f32", "trtri_stream_f32", "lauum_stream_f32"}}),
    (h100_params, None),
], ids=["DEFAULTS", "H100"])
def test_chip_smoke_paths_follow_the_table(params, routes, monkeypatch):
    # the smoke run's table-routed paths: the recursion's products under
    # DEFAULTS, one whole-matrix inverse where the H100 table's trtri cap
    # reaches 8192; every kernel stays on a named path
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(tblocked, "get_params", params)
    if routes is None:
        whole = params("trtri_f32")["mega_max_n"] >= 8192
        inverse = ({"trtri_stream_f32"} if whole
                   else {"gemm_f32", "trtri_stream_f32"})
        routes = {"strtri block_size=8192": ({"trtri_stream_f32"} if whole
                                             else {"trti2_f32"}),
                  "potri n=6000": inverse | {"lauum_stream_f32"},
                  "cpotri": inverse | {"lauum_stream_f32"}}
    got = chip_smoke.routed_paths()
    assert {k: set(v) for k, v in got.items()} == routes
    paths = {**chip_smoke.PATHS, **got}
    assert set().union(*paths.values()) == set(chip_smoke.SOURCES)
    for kernel, (_, _, path) in chip_smoke.SOURCES.items():
        assert kernel in paths[path], (kernel, path)


# ---------------------------------------------------------------------------
# the autotuner's decisions
# ---------------------------------------------------------------------------

def test_crossover_stops_at_the_first_recursion_win():
    readings = [(2048, 1.0, 2.0), (3072, 1.0, 2.0), (4096, 3.0, 2.0),
                (8192, 1.0, 2.0)]
    assert autotune.crossover_cap(readings) == 3072


@pytest.mark.parametrize("readings,cap", [
    ([(2048, 1.0, 2.0), (4096, 1.0, 2.0), (8192, 1.0, 2.0)], 8192),
    ([(2048, 2.0, 2.0), (4096, 1.0, 1.5)], 4096),            # a tie keeps
    ([(2048, 3.0, 2.0), (4096, 1.0, 2.0)], mega.MAX_N),      # never wins
    ([(2048, 1.0, 2.0), (8320, 1.0, 2.0)], 2048),            # above the cap
    ([(2048, 1.0, 2.0), (3000, 1.0, 2.0)], 2048),            # off the grid
    ([], mega.MAX_N),
])
def test_crossover_cap_rule(readings, cap):
    assert autotune.crossover_cap(readings) == cap


def leaf_rows(gp, potrf, trsm):
    """{candidate: {point: (median, spread)}} from per-point dicts."""
    return {c: {"GP": gp[c], "potrf": potrf[c], "trsm": trsm[c]}
            for c in gp}


def test_leaf_nb_takes_the_gp_step_best():
    rows = leaf_rows({512: (47.0, 0.2), 1024: (45.0, 0.2)},
                     {512: (70.0, 0.5), 1024: (70.4, 0.5)},
                     {512: (2.0, 0.1), 1024: (1.5, 0.1)})
    assert autotune.choose_leaf_nb(rows, 512, "GP") == 1024
    assert autotune.losses(rows, 1024, "GP") == {}


def test_leaf_nb_refuses_a_value_that_loses_elsewhere():
    # 1024 is the fastest on the GP step but loses 5 ms on potrf, more
    # than the two spreads together: the value in force stays, even where
    # it loses on a point itself
    rows = leaf_rows({512: (47.0, 0.2), 1024: (45.0, 0.2),
                      256: (48.0, 0.2)},
                     {512: (70.0, 0.5), 1024: (75.0, 0.5),
                      256: (70.5, 0.5)},
                     {512: (2.0, 0.1), 1024: (1.5, 0.1), 256: (2.5, 0.1)})
    assert autotune.losses(rows, 1024, "GP") == {"potrf": (512, 5.0)}
    assert autotune.choose_leaf_nb(rows, 512, "GP") == 512
    assert autotune.choose_leaf_nb(rows, 256, "GP") == 256


def test_leaf_nb_loss_within_the_spreads_does_not_count():
    rows = leaf_rows({512: (47.0, 0.2), 1024: (45.0, 0.2)},
                     {512: (70.0, 1.0), 1024: (71.5, 1.0)},
                     {512: (2.0, 0.1), 1024: (1.5, 0.1)})
    assert autotune.choose_leaf_nb(rows, 512, "GP") == 1024


def test_leaf_nb_incumbent_fastest_stays():
    rows = leaf_rows({512: (45.0, 0.2), 1024: (47.0, 0.2)},
                     {512: (75.0, 0.5), 1024: (70.0, 0.5)},
                     {512: (2.0, 0.1), 1024: (1.5, 0.1)})
    # 512 is the fastest on the GP step but loses on potrf and trsm
    assert set(autotune.losses(rows, 512, "GP")) == {"potrf", "trsm"}
    assert autotune.choose_leaf_nb(rows, 1024, "GP") == 1024
    assert autotune.choose_leaf_nb(rows, 512, "GP") == 512


@pytest.mark.parametrize("readings,want", [
    # the JAX package's r5 shape: per call ahead at 6144, hoisted at 8192
    ([(4096, (10.0, 0.1), (9.0, 0.1)), (6144, (30.0, 0.1), (25.0, 0.1)),
      (8192, (50.0, 0.1), (60.0, 0.1))], 7168),
    # hoisted ahead from the first size: the midpoint with n // 2
    ([(4096, (8.0, 0.1), (9.0, 0.1))], 3072),
    # the midpoint rounded up to 128: (4000 + 6000) // 2 = 5000 -> 5120
    ([(4000, (9.0, 0.1), (8.0, 0.1)), (6000, (7.0, 0.1), (8.0, 0.1))], 5120),
    # hoisted never ahead: off
    ([(4096, (10.0, 0.1), (9.0, 0.1)), (8192, (60.0, 0.1), (50.0, 0.1))],
     autotune.HOIST_OFF),
    # no size separates by more than both spreads: the default stays
    ([(4096, (10.0, 1.0), (9.5, 1.0)), (8192, (50.0, 5.0), (55.0, 5.0))],
     7168 + 128),
])
def test_hoist_min_n_rule(readings, want):
    assert autotune.hoist_min_n(readings, default=7168 + 128) == want


def test_merge_keeps_what_was_not_measured():
    old = {"potrf_f32": {"leaf_nb": 256, "mega_max_n": 2048},
           "trtri_f32": {"mega_max_n": 4096},
           "ozaki_f64": {"hoist_min_n": 7168, "hoist_min_n_trsm": 4096},
           "_meta": {"device_kind": "old", "note": "kept"}}
    snapshot = json.loads(json.dumps(old))
    new = {"potrf_f32": {"mega_max_n": 8192},
           "ozaki_f64": {"hoist_min_n": 6144},
           "_meta": {"device_kind": "new"}}
    got = autotune.merge_tables(old, new)
    assert got == {"potrf_f32": {"leaf_nb": 256, "mega_max_n": 8192},
                   "trtri_f32": {"mega_max_n": 4096},
                   "ozaki_f64": {"hoist_min_n": 6144,
                                 "hoist_min_n_trsm": 4096},
                   "_meta": {"device_kind": "new", "note": "kept"}}
    assert old == snapshot          # the table read is not modified
    assert autotune.merge_tables({}, new) == new


def test_standing_in_overlays_and_restores():
    real = tblocked.get_params
    with pytest.raises(RuntimeError):
        with autotune.standing_in({"trtri_f32": {"mega_max_n": 8192}}):
            assert tblocked.get_params("trtri_f32")["mega_max_n"] == 8192
            assert tblocked._mega_ok(8192, "trtri")
            # keys the candidate does not name come from the table in force
            assert (tblocked.get_params("potrf_f32")
                    == real("potrf_f32"))
            raise RuntimeError("the block ends")
    assert tblocked.get_params is real


def test_autotune_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "-m",
                          "cholesky_tpu_torch.tuning.autotune", "--quick"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


# ---------------------------------------------------------------------------
# bench_torch.py
# ---------------------------------------------------------------------------

def bench_py_keys() -> set:
    """The keys of bench.py's JSON line after a verified point: its
    ``_best`` dict, updated by ``_record``, which pops ``error``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "_best"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.FunctionDef) and node.name == "_record":
            for call in ast.walk(node):
                if isinstance(call, ast.Call) and isinstance(
                        call.func, ast.Attribute):
                    if call.func.attr == "update":
                        keys |= {k.value for k in call.args[0].keys}
                    elif call.func.attr == "pop":
                        keys.discard(call.args[0].value)
    return keys


def test_bench_torch_line_has_bench_py_keys():
    sys.path.insert(0, str(REPO))
    try:
        import bench_torch
    finally:
        sys.path.remove(str(REPO))
    want = bench_py_keys()
    assert want == {"metric", "value", "unit", "vs_baseline", "verify"}
    line = bench_torch.result_line(4096, 6350.04, "full")
    assert set(line) == want
    assert line == {"metric": "spotrf_gflops_n4096", "value": 6350.0,
                    "unit": "GFLOP/s", "vs_baseline": 36.29,
                    "verify": "full"}
    assert json.loads(json.dumps(line)) == line
    assert bench_torch.flops(4096) == 4096 ** 3 / 3 + 4096 ** 2 / 2 + 4096 / 6
    assert (bench_torch.N_QUICK, bench_torch.N_FIRST) == (1024, 4096)
    assert bench_torch.LADDER == (8192, 16384, 24576)
    assert bench_torch.PROJ_TOL == bench_torch.FULL_TOL == 1e-5
    assert set(bench_torch.STAGE_BUDGET_S) == set(bench_torch.LADDER)
