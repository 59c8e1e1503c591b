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

REPO = Path(__file__).resolve().parents[1]


def test_import_loads_neither_jax_nor_triton():
    code = (
        "import sys\n"
        "import cholesky_tpu_torch\n"
        "import cholesky_tpu_torch.ops.blocked, cholesky_tpu_torch.rng\n"
        "import cholesky_tpu_torch.ops.kernels._build\n"
        "import cholesky_tpu_torch.utils.benchlib\n"
        "bad = [m for m in ('jax', 'triton', 'cholesky_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_card():
    # the smoke run must never report success from a machine with no card
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_public_api():
    assert sorted(ct.__all__) == sorted([
        "potrf", "logdet", "logdet_from_factor", "Side", "Uplo", "Trans",
        "Diag", "set_error_handler", "set_xerbla"])


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


def test_tuning_defaults_and_mega_routing():
    assert get_params("potrf_f32") == {"leaf_nb": 512, "mega_max_n": 1024}
    assert get_params("trtri_f32") == {"mega_max_n": 1024}
    assert set(DEFAULTS) == {"matmul_f32", "syrk_f32", "potrf_f32",
                             "trtri_f32"}
    assert get_params("no_such_op") == {}
    assert blocked._mega_ok(1024) and blocked._mega_ok(100)
    assert not blocked._mega_ok(1025) and not blocked._mega_ok(200)
    assert not blocked._mega_ok(0)


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
