"""The GP model's RBF kernels (cholesky_tpu_torch/ops/kernels/rbf.py) on
the CPU: their plain twins against the model's full-square passes and the
JAX package's gradients, the routing of the model (float32 on the card
takes the kernels, everything else the plain passes), and the kernels'
place among the others. The kernels themselves run in
tests/test_torch_cuda.py.

Bounds: in f64 the lower-triangle sums and the full-square ones add the
same terms in another order, so they agree to a few ulps of Σ|terms| (the
log_amp sum cancels terms of about n: its value is far below Σ|terms|);
against JAX in f32 the model's own bound, 3000n eps-scaled
(tests/test_torch_gp.py)."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu.models import gp as jgp
from cholesky_tpu_torch.models import gp
from cholesky_tpu_torch.ops import kernels
from cholesky_tpu_torch.ops.kernels import _build, rbf
from tests.util import assert_close

REPO = Path(__file__).resolve().parents[1]
N, D = 128, 3
EPS64 = float(np.finfo(np.float64).eps)


@functools.lru_cache(maxsize=None)
def data(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (n, d))
    y = np.sin(3.0 * X.sum(axis=1)) + 0.1 * rng.standard_normal(n)
    return X, y


def params(dtype, values=(0.1, -0.2, -1.0)):
    return gp.GPParams(*(torch.tensor(v, dtype=dtype) for v in values))


def solve_pieces(p, X, y):
    """K⁻¹'s lower triangle from potri and α = K⁻¹y, as the model makes
    them."""
    F, info = ct.potrf("L", gp._kmatrix(p, X))
    assert int(info) == 0
    z = ct.trsm("L", "L", "N", "N", 1.0, F, y[:, None])
    alpha = ct.trsm("L", "L", "T", "N", 1.0, F, z)[:, 0]
    Kinv_tri, _ = ct.potri("L", F)
    return Kinv_tri, alpha


def magnitudes(p, X, Kinv_tri, alpha):
    """Σ|terms| of each of the three sums, in f64: the scale of their
    rounding."""
    Kinv = torch.tril(Kinv_tri) + torch.tril(Kinv_tri, -1).T
    W = Kinv - alpha[:, None] * alpha[None, :]
    ell2 = torch.exp(2.0 * p.log_len)
    Dm = rbf.sqdist_plain(X, X)
    Kf = torch.exp(2.0 * p.log_amp) * torch.exp(-0.5 * Dm / ell2)
    noise = torch.exp(2.0 * p.log_noise)
    return (float((W * 2.0 * Kf).abs().sum()),
            float((W * Kf * Dm / ell2).abs().sum()),
            float(W.diagonal().abs().sum() * noise))


@pytest.mark.parametrize("n,d,seed", [(N, D, 0), (200, 8, 1), (37, 1, 2)])
def test_lower_triangle_sums_equal_the_full_square_in_f64(n, d, seed):
    X, y = (torch.from_numpy(a) for a in data(n, d, seed))
    p = params(torch.float64)
    _, g_full, info = gp.gp_nll_and_grads(p, X, y)    # the full square
    assert int(info) == 0
    Kinv_tri, alpha = solve_pieces(p, X, y)
    g_low = rbf.rbf_grad_plain(Kinv_tri, alpha, X, *p)
    for name, a, b, scale in zip(gp.GPParams._fields, g_low, g_full,
                                 magnitudes(p, X, Kinv_tri, alpha)):
        assert a.dtype == torch.float64 and a.ndim == 0
        assert abs(float(a) - float(b)) <= 64 * EPS64 * scale, (
            f"{name}: lower {float(a)!r} full {float(b)!r}")


def test_lower_triangle_sums_ignore_the_upper_triangle():
    X, y = (torch.from_numpy(a) for a in data())
    p = params(torch.float64)
    Kinv_tri, alpha = solve_pieces(p, X, y)
    dirty = torch.tril(Kinv_tri) + torch.full_like(Kinv_tri,
                                                   float("nan")).triu(1)
    for a, b in zip(rbf.rbf_grad_plain(dirty, alpha, X, *p),
                    rbf.rbf_grad_plain(Kinv_tri, alpha, X, *p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lower_triangle_sums_vs_jax(dtype):
    Xn, yn = (a.astype(dtype) for a in data())
    p_j = jgp.GPParams(*(jnp.asarray(v, dtype) for v in (0.1, -0.2, -1.0)))
    _, g_j, info_j = jgp.gp_nll_and_grads(p_j, jnp.asarray(Xn),
                                          jnp.asarray(yn))
    X, y = torch.from_numpy(Xn), torch.from_numpy(yn)
    p = gp.params_from_jax(p_j, device="cpu")
    Kinv_tri, alpha = solve_pieces(p, X, y)
    g = rbf.rbf_grad_plain(Kinv_tri, alpha, X, *p)
    assert int(info_j) == 0
    for name, a, b in zip(gp.GPParams._fields, g, g_j):
        assert_close(np.asarray(float(a)), np.asarray(float(b)), dtype,
                     3000 * N, f"gradient {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_f64_take_the_plain_passes(dtype):
    X, y = (torch.from_numpy(a).to(dtype) for a in data())
    Xs = X[:17] * 0.5
    p = params(dtype)
    kernels.reset_launch_counts()
    nll, g, info = gp.gp_nll_and_grads(p, X, y)
    mean, var, info_p = gp.gp_predict(p, X, y, Xs)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert int(info) == int(info_p) == 0
    # the kernel matrices are the plain twin's bit for bit
    K = gp._kmatrix(p, X)
    want = rbf.rbf_plain(X, X, *p[:2])
    want.diagonal().add_(torch.exp(2.0 * p.log_noise) + 1e-6)
    assert torch.equal(K, want)
    assert torch.equal(gp.rbf_kernel(p, X, Xs), rbf.rbf_plain(X, Xs, *p[:2]))
    # the gradients are the full-square passes', not the lower form's
    assert not gp._card_f32(X, p)


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (7, 5, 13), (130, 70, 8)])
def test_cpu_wrappers_take_the_twins(n, m, d):
    g = torch.Generator().manual_seed(n)
    X1, X2 = torch.rand(n, d, generator=g), torch.rand(m, d, generator=g)
    p = params(torch.float32)
    kernels.reset_launch_counts()
    assert torch.equal(rbf.rbf_f32(X1, X2, *p[:2]),
                       rbf.rbf_plain(X1, X2, *p[:2]))
    assert torch.equal(rbf.rbf_f32(X1, X1, *p, jitter=1e-6),
                       rbf.rbf_plain(X1, X1, *p, jitter=1e-6))
    assert torch.equal(rbf.sqdist_f32(X1, X2), rbf.sqdist_plain(X1, X2))
    Kinv = torch.rand(n, n, generator=g)
    alpha = torch.rand(n, generator=g)
    for a, b in zip(rbf.rbf_grad_f32(Kinv, alpha, X1, *p),
                    rbf.rbf_grad_plain(Kinv, alpha, X1, *p)):
        assert torch.equal(a, b)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    X = torch.rand(5, 3)
    p = params(torch.float32)
    with pytest.raises(ValueError):
        rbf.rbf_f32(X.double(), X.double(), *p[:2])
    with pytest.raises(ValueError):
        rbf.rbf_f32(X, torch.rand(5, 2), *p[:2])
    with pytest.raises(ValueError):
        rbf.rbf_f32(X, X.clone(), *p)             # the diagonal needs X2 = X1
    with pytest.raises(ValueError):
        rbf.rbf_f32(X, X, *params(torch.float64)[:2])
    with pytest.raises(ValueError):
        rbf.rbf_grad_f32(torch.rand(4, 4), torch.rand(5), X, *p)


def test_both_kernels_are_registered_and_counted():
    assert kernels.KERNELS["rbf_f32"] is rbf.rbf_f32
    assert kernels.KERNELS["rbf_grad_f32"] is rbf.rbf_grad_f32
    counts = kernels.launch_counts()
    assert counts["rbf_f32"] == rbf.rbf_f32.launches
    assert counts["rbf_grad_f32"] == rbf.rbf_grad_f32.launches
    assert (_build.CSRC / "rbf.cu").exists()


def test_rbf_module_imports_without_nvcc(tmp_path):
    # no nvcc on the path and none under CUDA_HOME: importing the module
    # and running the twins builds nothing
    code = (
        "import torch\n"
        "from cholesky_tpu_torch.ops.kernels import _build, rbf\n"
        "X = torch.rand(9, 2)\n"
        "p = [torch.tensor(0.0)] * 3\n"
        "rbf.rbf_f32(X, X, *p)\n"
        "rbf.rbf_grad_f32(torch.eye(9), torch.ones(9), X, *p)\n"
        "assert _build._lib is None\n"
        "print('built nothing')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path), CUDA_PATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "built nothing"
