"""The four kernels of the port's f32 potrf path (cholesky_tpu_torch/ops/
kernels/). On the CPU each wrapper runs its plain torch twin, which is held
here against the Pallas kernel it replaces, run in interpret mode as the
JAX package's own tests run it (tests/test_mega.py, test_pallas_kernels.py).
The CUDA kernels themselves are held against their twins on the card by
tests/test_torch_cuda.py.

Tolerances are the repo's eps-scaled bounds (tests/util.py): 2k+3 for a
product of depth k, 8n for a Cholesky factor, 60n for a triangular
inverse, as the JAX package's tests use."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_tpu.ops.pallas import gemm as pgemm
from cholesky_tpu.ops.pallas import mega as pmega
from cholesky_tpu.ops.pallas import syrk as psyrk
from cholesky_tpu_torch.ops.kernels import (gemm_f32, potrf_block_f32,
                                            syrk_lower_f32, trtri_block_f32)
from tests.util import assert_close

F32 = np.float32


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(F32)


def spd_np(n, cond=50.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return (0.5 * (A + A.T)).astype(F32)


def lower_factor(n, seed=0):
    """A row-major f32 Cholesky factor, the input trtri sees on the path."""
    return np.ascontiguousarray(
        np.linalg.cholesky(spd_np(n, seed=seed).astype(np.float64)), F32)


# ---------------------------------------------------------------------------
# gemm_f32 — replaces ops/pallas/gemm.py:matmul_f32
# ---------------------------------------------------------------------------

GEMM_CASES = {
    # name: (m, n, k, alpha, beta, A transposed view?, B transposed view?)
    "ragged": (200, 300, 130, 1.0, 0.0, False, False),
    "alpha_beta": (200, 300, 130, -1.0, 1.0, False, False),
    "scaled": (128, 96, 64, 0.5, 2.0, False, False),
    "transposed_views": (200, 300, 130, 1.0, 0.0, True, True),
    "transposed_B_in_place": (256, 128, 192, -1.0, 1.0, False, True),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_gemm_twin_vs_pallas(case):
    m, n, k, alpha, beta, ta, tb = GEMM_CASES[case]
    A, B, C = rand((m, k), 1), rand((k, n), 2), rand((m, n), 3)
    # a transposed operand arrives as a view of its transpose, as in
    # _trsm_rlt's B·Tᵀ: the wrapper takes its strides, no copy
    At = torch.from_numpy(A.T.copy()).T if ta else torch.from_numpy(A)
    Bt = torch.from_numpy(B.T.copy()).T if tb else torch.from_numpy(B)
    Ct = torch.from_numpy(C.copy())
    if beta:
        got = gemm_f32(At, Bt, Ct, alpha=alpha, beta=beta, out=Ct)
        assert got.data_ptr() == Ct.data_ptr()
        ref = pgemm.matmul_f32(jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(C), alpha=alpha, beta=beta)
    else:
        got = gemm_f32(At, Bt, alpha=alpha)
        ref = pgemm.matmul_f32(jnp.asarray(A), jnp.asarray(B), alpha=alpha)
    assert_close(got.numpy(), np.asarray(ref), F32, 2 * k + 3, f"gemm {case}")


def test_gemm_rejects_bad_arguments():
    A = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        gemm_f32(A, torch.zeros(4, 3))                       # inner dims
    with pytest.raises(ValueError):
        gemm_f32(A, torch.zeros(3, 2), beta=1.0)             # beta, no C
    with pytest.raises(ValueError):
        gemm_f32(A.double(), torch.zeros(3, 2).double())     # f64
    with pytest.raises(ValueError):
        gemm_f32(A, torch.zeros(3, 2), out=torch.zeros(2, 2))
    with pytest.raises(ValueError):                          # aliased out
        gemm_f32(A, torch.zeros(3, 2), out=torch.zeros(4, 1).expand(4, 2))
    with pytest.raises(ValueError):
        syrk_lower_f32(1.0, A, 0.0, torch.zeros(4, 1).expand(4, 4))


# ---------------------------------------------------------------------------
# syrk_lower_f32 — replaces ops/pallas/syrk.py:syrk_f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,alpha,beta", [(200, 130, -1.0, 1.0),
                                            (128, 256, 1.0, 0.0)])
def test_syrk_twin_vs_pallas(n, k, alpha, beta):
    A, C = rand((n, k), 4), rand((n, n), 5)
    Ct = torch.from_numpy(C.copy())
    syrk_lower_f32(alpha, torch.from_numpy(A), beta, Ct)
    ref = np.asarray(psyrk.syrk_f32(jnp.asarray(A), jnp.asarray(C),
                                    alpha=alpha, beta=beta))
    got = Ct.numpy()
    assert_close(np.tril(got), np.tril(ref), F32, 2 * k + 3, "syrk lower")
    # the strict upper of C is the caller's, bit for bit, in both
    iu = np.triu_indices(n, 1)
    np.testing.assert_array_equal(got[iu], C[iu])
    np.testing.assert_array_equal(ref[iu], C[iu])


def test_syrk_on_views_of_one_buffer():
    # the recursion's trailing update: A = W[n1:, :n1], C = W[n1:, n1:]
    W = rand((256, 256), 6)
    Wt = torch.from_numpy(W.copy())
    syrk_lower_f32(-1.0, Wt[128:, :128], 1.0, Wt[128:, 128:])
    ref = np.asarray(psyrk.syrk_f32(jnp.asarray(W[128:, :128]),
                                    jnp.asarray(W[128:, 128:]),
                                    alpha=-1.0, beta=1.0))
    got = Wt.numpy()
    assert_close(np.tril(got[128:, 128:]), np.tril(ref), F32, 2 * 128 + 3,
                 "syrk views")
    np.testing.assert_array_equal(got[:, :128], W[:, :128])
    np.testing.assert_array_equal(got[:128], W[:128])


# ---------------------------------------------------------------------------
# potrf_block_f32 — replaces ops/pallas/mega.py:potrf_vmem_f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 128, 256])
def test_potrf_block_twin_vs_pallas(n):
    A = spd_np(n)
    At = torch.from_numpy(A.copy())
    info = potrf_block_f32(At)
    L, info_j = pmega.potrf_vmem_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == 0
    assert info.dtype == torch.int32 and info.ndim == 0
    got = At.numpy()
    assert np.all(np.triu(got, 1) == 0.0)
    assert_close(got, np.asarray(L), F32, 8 * n, f"potrf_block n={n}")


def test_potrf_block_on_a_view():
    # a diagonal block of the working buffer: rows longer than the block
    A = spd_np(128)
    buf = torch.zeros(128, 256)
    buf[:, 64:192] = torch.from_numpy(A)
    info = potrf_block_f32(buf[:, 64:192])
    L, _ = pmega.potrf_vmem_f32(jnp.asarray(A))
    assert int(info) == 0
    assert_close(buf[:, 64:192].numpy(), np.asarray(L), F32, 8 * 128,
                 "potrf_block view")
    assert torch.all(buf[:, :64] == 0) and torch.all(buf[:, 192:] == 0)


def test_potrf_block_nonpd_info_and_finite():
    A = spd_np(256, cond=10.0)
    A[4, 4] = -1.0
    At = torch.from_numpy(A.copy())
    info = potrf_block_f32(At)
    L, info_j = pmega.potrf_vmem_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == 5
    assert torch.isfinite(At).all() and np.isfinite(np.asarray(L)).all()
    assert_close(At.numpy()[:4, :4], np.asarray(L)[:4, :4], F32, 8 * 256,
                 "potrf_block nonpd leading block")


def test_potrf_block_nan_pivot():
    A = spd_np(256, cond=10.0)
    A[7, 7] = np.nan
    At = torch.from_numpy(A.copy())
    info = potrf_block_f32(At)
    L, info_j = pmega.potrf_vmem_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == 8
    # nothing but the input NaN at its own position is non-finite
    for X in (At.numpy(), np.asarray(L)):
        assert {tuple(ix) for ix in np.argwhere(~np.isfinite(X))} <= {(7, 7)}


def test_potrf_block_reads_only_lower():
    A = spd_np(128)
    A[np.triu_indices(128, 1)] = np.nan
    At = torch.from_numpy(A)
    assert int(potrf_block_f32(At)) == 0
    assert torch.isfinite(At).all()


def test_potrf_block_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        potrf_block_f32(torch.eye(1025))                    # n > MAX_N
    with pytest.raises(ValueError):
        potrf_block_f32(torch.eye(8, dtype=torch.float64))  # f64
    with pytest.raises(ValueError):
        potrf_block_f32(torch.rand(8, 8).T)                 # column-major
    with pytest.raises(ValueError):
        potrf_block_f32(torch.eye(8)[::2, ::2])             # strided rows
    with pytest.raises(ValueError):
        trtri_block_f32(torch.eye(4, 5))                    # not square


# ---------------------------------------------------------------------------
# trtri_block_f32 — replaces ops/pallas/mega.py:trtri_vmem_f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 128, 256])
def test_trtri_block_twin_vs_pallas(n):
    L = lower_factor(n)
    W, info = trtri_block_f32(torch.from_numpy(L))
    ref, info_j = pmega.trtri_vmem_f32(jnp.asarray(L))
    assert int(info) == int(info_j) == 0
    got = W.numpy()
    assert np.all(np.triu(got, 1) == 0.0)
    assert_close(got, np.asarray(ref), F32, 60 * n, f"trtri_block n={n}")


def test_trtri_block_zero_diag_info():
    # test_mega.py:80-88: info 10, treated as 1, output finite
    A = np.tril(spd_np(256))
    np.fill_diagonal(A, 1.0)
    A[9, 9] = 0.0
    W, info = trtri_block_f32(torch.from_numpy(A))
    ref, info_j = pmega.trtri_vmem_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == 10
    assert torch.isfinite(W).all()
    assert_close(W.numpy(), np.asarray(ref), F32, 60 * 256, "trtri zero diag")


def test_trtri_block_reads_only_lower():
    L = lower_factor(64)
    L[np.triu_indices(64, 1)] = np.nan
    W, info = trtri_block_f32(torch.from_numpy(L))
    assert int(info) == 0 and torch.isfinite(W).all()
