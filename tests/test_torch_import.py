"""Import hygiene and the small pieces of the port's scaffold: importing
cholesky_tpu_torch (and every module the card path imports) loads neither
JAX nor Triton and builds nothing; types, error hooks, the tuning table,
the build's failure mode and the timing helper behave as documented."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu_torch import types
from cholesky_tpu_torch.ops import blocked
from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.tuning import DEFAULTS, get_params
from cholesky_tpu_torch.utils import benchlib, errors
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def test_import_loads_neither_jax_nor_triton():
    code = (
        "import sys\n"
        "import cholesky_tpu_torch\n"
        "import cholesky_tpu_torch.ops.blocked, cholesky_tpu_torch.rng\n"
        "import cholesky_tpu_torch.models\n"
        "import cholesky_tpu_torch.ops.kernels._build\n"
        "import cholesky_tpu_torch.ops.ozaki, cholesky_tpu_torch.ops.typed\n"
        "import cholesky_tpu_torch.ops.complex_embed\n"
        "import cholesky_tpu_torch.ops.kernels.prng\n"
        "import cholesky_tpu_torch.rng.device\n"
        "import cholesky_tpu_torch.utils.benchlib\n"
        "import cholesky_tpu_torch.tuning.autotune\n"
        "import cholesky_tpu_torch.parallel\n"
        "import cholesky_tpu_torch.parallel.launch\n"
        "import cholesky_tpu_torch.parallel.blas\n"
        "import cholesky_tpu_torch.models.gp_dist\n"
        "import cholesky_tpu_torch.entry\n"
        "import cholesky_tpu_torch.utils.profiling\n"
        "import cholesky_tpu_torch.runtime\n"
        "import cholesky_tpu_torch.tools.sweep\n"
        "import cholesky_tpu_torch.tools.minibench\n"
        "import cholesky_tpu_torch.tools.report\n"
        "import cholesky_tpu_torch.tools.goldens\n"
        "import tests.torch_dist_ranks\n"
        "import bench_torch\n"
        "bad = [m for m in ('jax', 'triton', 'cholesky_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    # this and each child below: 4-9 s in the suite under six workers
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=40)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_card():
    # the smoke run must never report success from a machine with no card
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=40)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_torch_fails_without_a_card():
    # the headline bench prints no number from a machine with no card
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=40)
    assert out.returncode != 0
    assert '"value"' not in out.stdout


def test_chip_compare_fails_without_a_card():
    # the comparison prints no numbers from a machine with no card
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "chip_compare.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=40)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("mangled,name", [
    ("_ZN39_GLOBAL__N__8bf87cd6_7_leaf_cu_25769aae15potf2_update128ILb1EEEv"
     "PfxPKfiiiPKi", "potf2_update128<Lb1>"),
    ("_ZN47_GLOBAL__N__64f886f1_14_trtri_block_cu_66e7af1f22trtri_block_f32_"
     "kernelEPKfxPfxS2_iPii", "trtri_block_f32_kernel"),
    ("_ZN2ct4t1288tile_xytILb1ELb0ELb1EEEvPKfxx", "tile_xyt<Lb1Lb0Lb1>"),
    ("ct_gemm_f32", "ct_gemm_f32"),
])
def test_chip_smoke_names_the_kernels_in_ptxas_log(mangled, name):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.short_name(mangled) == name


@pytest.mark.parametrize("intervals,ms", [
    ([], 0.0),
    ([(0.0, 1000.0)], 1.0),
    # a launch scheduled early waits inside its predecessor's run
    ([(0.0, 1000.0), (400.0, 2500.0)], 2.5),
    ([(3000.0, 3500.0), (0.0, 1000.0), (200.0, 300.0)], 1.5),
])
def test_chip_smoke_busy_ms(intervals, ms):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.busy_ms(intervals) == pytest.approx(ms)


def test_public_api():
    routines = ["potrf", "potf2", "logdet", "trtri", "trtri2", "trti2",
                "lauum", "lauu2", "potri", "gemm", "syrk", "trmm", "trmm2",
                "trsm"]
    # s/d/c/z, as in the JAX package: no csyrk/zsyrk, cherk/zherk instead
    typed = [letter + r for letter in "sdcz" for r in routines
             if not (letter in "cz" and r == "syrk")] + ["cherk", "zherk"]
    assert sorted(ct.__all__) == sorted(
        routines + typed + ["herk", "logdet_from_factor", "Side", "Uplo",
                            "Trans", "Diag", "set_error_handler",
                            "set_xerbla", "xerbla"])
    assert all(callable(getattr(ct, name)) for name in typed)


def test_xerbla_is_exported_as_in_the_jax_package():
    import cholesky_tpu
    assert "xerbla" in cholesky_tpu.__dict__ and "xerbla" in ct.__all__
    assert ct.xerbla is errors.xerbla
    seen = []
    prev = ct.set_xerbla(lambda routine, arg, msg="": seen.append(
        (routine, arg, msg)))
    try:
        with pytest.raises(ValueError, match="parameter 3"):
            ct.xerbla("spotrf", 3, "n < 0")
    finally:
        ct.set_xerbla(prev)
    assert seen == [("spotrf", 3, "n < 0")]


def test_typed_names_equal_the_jax_packages():
    import cholesky_tpu.ops.typed as jtyped
    from cholesky_tpu_torch.ops import typed
    assert set(typed.__all__) == set(jtyped.__all__)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("enum_cls,norm", [
    (types.Uplo, types.norm_uplo), (types.Side, types.norm_side),
    (types.Trans, types.norm_trans), (types.Diag, types.norm_diag)])
def test_flag_normalization(enum_cls, norm):
    for member in enum_cls:
        assert norm(member.value.lower()) is member
        assert norm(member) is member
    with pytest.raises(ValueError):
        norm("X")


def test_precision_registry():
    assert types.precision_letter(torch.float32) == "s"
    assert types.real_dtype(torch.complex128) == torch.float64
    assert types.is_complex(torch.complex64)
    assert not types.is_complex(torch.float64)


def test_xerbla_hook_sees_the_bad_argument():
    seen = []
    prev = ct.set_xerbla(lambda routine, arg, msg="": seen.append(
        (routine, arg)))
    try:
        with pytest.raises(ValueError):
            ct.potrf("L", torch.zeros(3, 4))
    finally:
        ct.set_xerbla(prev)
    assert seen == [("potrf", 2)]


def test_error_handler_hook():
    seen = []
    prev = ct.set_error_handler(lambda *a: seen.append(a))
    try:
        errors.report_error("cudaMalloc", 2, "out of memory", "potrf")
    finally:
        ct.set_error_handler(prev)
    assert seen == [("cudaMalloc", 2, "out of memory", "potrf", "")]


def test_tuning_defaults_and_mega_routing(monkeypatch):
    # the shipped DEFAULTS, and _mega_ok's routes under them: pinned, so
    # that the test means the same on a card whose own table differs
    assert DEFAULTS["potrf_f32"] == {"leaf_nb": 512, "mega_max_n": 8192}
    assert DEFAULTS["trtri_f32"] == {"mega_max_n": 4096}
    assert DEFAULTS["lauum_f32"] == {"mega_max_n": 8192}
    # only the keys the port reads
    assert set(DEFAULTS) == {"potrf_f32", "trtri_f32", "lauum_f32"}
    # a card without a table reads DEFAULTS
    for op in DEFAULTS:
        assert get_params(op, "No Such Card") == DEFAULTS[op]
    assert get_params("no_such_op") == {}
    monkeypatch.setattr(blocked, "get_params",
                        lambda op, device_kind=None: dict(DEFAULTS.get(op,
                                                                       {})))
    assert blocked._mega_ok(1024) and blocked._mega_ok(100)
    assert not blocked._mega_ok(1025) and not blocked._mega_ok(200)
    assert not blocked._mega_ok(0)
    # each op streams to its tuned cap, in multiples of 128
    assert blocked._mega_ok(2048) and blocked._mega_ok(8192)
    assert not blocked._mega_ok(8320) and not blocked._mega_ok(1100)
    assert blocked._mega_ok(4096, "trtri") and blocked._mega_ok(1152, "trtri")
    assert not blocked._mega_ok(8192, "trtri")
    assert not blocked._mega_ok(1100, "trtri")
    assert blocked._mega_ok(8192, "lauum")
    assert not blocked._mega_ok(8320, "lauum")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    # a missing compiler is an error, never a fallback
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_bench_op_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        benchlib.bench_op(lambda x: x, torch.zeros(2))
