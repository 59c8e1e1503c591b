"""The port's CUDA kernels on the card, each against its plain torch twin,
and the f32 potrf path through them. Every test is marked ``cuda`` and
skips where torch sees no CUDA device.

A machine with a card need not have JAX installed, so this file imports
neither JAX nor tests/util.py, and the repo's tests/conftest.py (which
imports JAX) is bypassed there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The bound is tests/util.py's, restated: fpe x 2 x eps_f32 x max(1, |ref|),
with fpe 2k+3 for a product of depth k, 8n for a Cholesky factor, 60n
for a triangular inverse or solve and 3000n for potri."""

import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu_torch.models import gp
from cholesky_tpu_torch.ops import kernels
from cholesky_tpu_torch.ops.kernels import gemm, leaf, mega, syrk

# the blocked recursion's kernels, which potrf runs with a block size
POTRF_PATH = ("gemm_f32", "syrk_lower_f32", "potrf_block_f32",
              "trtri_block_f32")

EPS32 = float(np.finfo(np.float32).eps)


def assert_close(got, ref, fpe, what):
    got = got.double().cpu()
    ref = ref.double().cpu()
    bound = fpe * 2.0 * EPS32 * max(1.0, float(ref.abs().max()))
    diff = float((got - ref).abs().max())
    assert diff <= bound, f"{what}: max abs diff {diff:.3e} > {bound:.3e}"


def spd(n, cond=50.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return torch.from_numpy((0.5 * (A + A.T)).astype(np.float32))


def rand(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gemm_vs_twin(cuda):
    X, T = rand((1000, 512), 1).to(cuda), rand((512, 300), 2).to(cuda)
    assert_close(kernels.gemm_f32(X, T), gemm.gemm_plain(X, T),
                 2 * 512 + 3, "gemm")
    # in place, beta = 1, on a slice view, with a transposed operand
    W = rand((700, 900), 3).to(cuda)
    M = rand((400, 500), 4).to(cuda)
    want = gemm.gemm_plain(W[:, :500], M.T, W[:, 500:].clone(), alpha=-1.0,
                           beta=1.0)
    kernels.gemm_f32(W[:, :500], M.T, W[:, 500:], alpha=-1.0, beta=1.0,
                     out=W[:, 500:])
    assert_close(W[:, 500:], want, 2 * 500 + 3, "gemm in place")


@pytest.mark.cuda
def test_syrk_vs_twin(cuda):
    W = rand((600, 1100), 5).to(cuda)
    A, C = W[:, :500], W[:, 500:]
    want = syrk.syrk_lower_plain(-1.0, A, 1.0, C.clone())
    C0 = C.clone()
    kernels.syrk_lower_f32(-1.0, A, 1.0, C)
    assert_close(torch.tril(C), torch.tril(want), 2 * 500 + 3, "syrk")
    assert torch.equal(torch.triu(C, 1), torch.triu(C0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 512, 1024])
def test_potrf_block_vs_twin(cuda, n):
    A = spd(n).to(cuda)
    want = A.clone()
    i_ref = mega.potrf_block_plain(want)
    info = kernels.potrf_block_f32(A)
    assert int(info) == int(i_ref) == 0
    assert_close(A, want, 8 * n, f"potrf_block n={n}")


@pytest.mark.cuda
def test_potrf_block_failed_pivots(cuda):
    A = spd(256, cond=10.0).to(cuda)
    A[4, 4] = -1.0
    assert int(kernels.potrf_block_f32(A)) == 5
    assert bool(torch.isfinite(A).all())
    A = spd(256, cond=10.0).to(cuda)
    A[7, 7] = float("nan")
    assert int(kernels.potrf_block_f32(A)) == 8
    bad = (~torch.isfinite(A)).nonzero().tolist()
    assert all(ix == [7, 7] for ix in bad), bad


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 512])
def test_trtri_block_vs_twin(cuda, n):
    L = torch.linalg.cholesky(spd(n).double()).float().contiguous().to(cuda)
    W, info = kernels.trtri_block_f32(L)
    want, i_ref = mega.trtri_block_plain(L)
    assert int(info) == int(i_ref) == 0
    assert_close(W, want, 60 * n, f"trtri_block n={n}")
    Z = L.clone()
    Z[9, 9] = 0.0
    W, info = kernels.trtri_block_f32(Z)
    assert int(info) == 10 and bool(torch.isfinite(W).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1152, 2048])
def test_potrf_stream_vs_twin(cuda, n):
    A = spd(n).to(cuda)
    want = A.clone()
    i_ref = mega.potrf_stream_plain(want)
    A[torch.ones_like(A, dtype=torch.bool).triu(1)] = float("nan")
    info = kernels.potrf_stream_f32(A)
    assert int(info) == int(i_ref) == 0
    assert bool((torch.triu(A, 1) == 0).all())
    assert_close(A, want, 8 * n, f"potrf_stream n={n}")


@pytest.mark.cuda
def test_potrf_stream_failed_pivots(cuda):
    A = spd(1152, cond=10.0).to(cuda)
    A[300, 300] = -1.0
    assert int(kernels.potrf_stream_f32(A)) == 301
    assert bool(torch.isfinite(A).all())
    A = spd(1152, cond=10.0).to(cuda)
    A[7, 7] = float("nan")
    assert int(kernels.potrf_stream_f32(A)) == 8
    bad = (~torch.isfinite(A)).nonzero().tolist()
    assert all(ix == [7, 7] for ix in bad), bad


@pytest.mark.cuda
@pytest.mark.parametrize("n,uplo", [(1000, "L"), (1536, "U"), (2048, "L")])
def test_potrf_main_path(cuda, n, uplo):
    # one whole-matrix kernel: potrf_block_f32 up to 1024, potrf_stream_f32
    # above it
    A = spd(n)
    kernels.reset_launch_counts()
    F, info = ct.potrf(uplo, A.to(cuda))
    assert int(info) == 0
    counts = kernels.launch_counts()
    assert counts["potrf_block_f32" if n <= 1024 else "potrf_stream_f32"] == 1
    ref = torch.linalg.cholesky(A.double())
    got = torch.tril(F) if uplo == "L" else torch.triu(F).T
    assert_close(got, ref, 8 * n, f"potrf n={n} {uplo}")


@pytest.mark.cuda
def test_potrf_blocked_path(cuda):
    # a block size sends potrf through the recursion over its leaves
    n = 2048
    A = spd(n)
    kernels.reset_launch_counts()
    F, info = ct.potrf("L", A.to(cuda), block_size=512)
    assert int(info) == 0
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in POTRF_PATH), counts
    ref = torch.linalg.cholesky(A.double())
    assert_close(torch.tril(F), ref, 8 * n, "potrf block_size=512")


@pytest.mark.cuda
def test_potrf_nonpd_and_logdet(cuda):
    A = spd(2048, cond=10.0).to(cuda)
    val, info = ct.logdet("L", A)
    ref = torch.linalg.slogdet(A.double())[1]
    assert int(info) == 0
    assert abs(float(val) - float(ref)) <= 2048 * EPS32 * abs(float(ref))
    A[1500, 1500] = -1.0
    F, info = ct.potrf("L", A)
    assert int(info) == 1501


def factor(n, seed=0):
    """A row-major f32 Cholesky factor on the card."""
    return torch.linalg.cholesky(spd(n, seed=seed).double()).float()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1152, 2048])
def test_trtri_stream_vs_twin(cuda, n):
    L = factor(n).contiguous().to(cuda)
    W, info = kernels.trtri_stream_f32(L)
    want, i_ref = mega.trtri_stream_plain(L)
    assert int(info) == int(i_ref) == 0
    assert bool((torch.triu(W, 1) == 0).all())
    assert_close(W, want, 60 * n, f"trtri_stream n={n}")
    Z = L.clone()
    Z[9, 9] = 0.0
    Z[torch.ones_like(Z, dtype=torch.bool).triu(1)] = float("nan")
    W, info = kernels.trtri_stream_f32(Z)
    assert int(info) == 10 and bool(torch.isfinite(W).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1280])
def test_lauum_stream_vs_twin(cuda, n):
    L = factor(n, seed=1).contiguous().to(cuda)
    want = mega.lauum_stream_plain(L)
    L[torch.ones_like(L, dtype=torch.bool).triu(1)] = float("nan")
    B = kernels.lauum_stream_f32(L)
    assert bool(torch.isfinite(B).all())
    assert bool((torch.triu(B, 1) == 0).all())
    assert_close(B, want, 2 * n + 3, f"lauum_stream n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 512])
def test_lauu2_vs_twin(cuda, n):
    W = rand((n, n + 40), 6).to(cuda)
    A = W[:, 20:20 + n]                  # a leaf of a wider buffer
    B = kernels.lauu2_f32(A)
    want = leaf.lauu2_plain(A)
    assert_close(torch.tril(B), torch.tril(want), 2 * n + 3, f"lauu2 n={n}")
    up = torch.ones(n, n, dtype=torch.bool, device=cuda).triu(1)
    assert torch.equal(B[up], A[up])


@pytest.mark.cuda
@pytest.mark.parametrize("n,bs,uplo", [(2048, None, "L"), (1536, 512, "U"),
                                       (4096, None, "L")])
def test_potri_on_the_card(cuda, n, bs, uplo):
    A = spd(n, cond=30.0)
    L = torch.linalg.cholesky(A.double())
    F = (L if uplo == "L" else L.T).float().contiguous().to(cuda)
    kernels.reset_launch_counts()
    inv, info = ct.potri(uplo, F, block_size=bs)
    assert int(info) == 0
    counts = kernels.launch_counts()
    if bs is None:
        assert counts["lauum_stream_f32"] > 0, counts
        assert counts["trtri_stream_f32" if n > 1024 else
                      "trtri_block_f32"] > 0, counts
    else:
        assert counts["lauu2_f32"] > 0, counts
    ref = torch.cholesky_inverse(L)
    tri = torch.tril if uplo == "L" else torch.triu
    assert_close(tri(inv), tri(ref), 3000 * n, f"potri n={n} {uplo}")


@pytest.mark.cuda
@pytest.mark.parametrize("side,uplo,trans,diag", [
    ("L", "L", "N", "N"), ("L", "L", "T", "N"), ("R", "U", "N", "U"),
    ("R", "L", "T", "N"), ("L", "U", "T", "U")])
def test_trsm_on_the_card(cuda, side, uplo, trans, diag):
    n, m = 1536, 200
    A = torch.from_numpy(np.tril(np.random.default_rng(7).uniform(
        -0.5, 0.5, (n, n)) / np.sqrt(n)) + 2.0 * np.eye(n))
    A = (A if uplo == "L" else A.T).contiguous()
    B = rand((n, m) if side == "L" else (m, n), 8)
    kernels.reset_launch_counts()
    X = ct.trsm(side, uplo, trans, diag, 0.5, A.float().to(cuda),
                B.to(cuda))
    counts = kernels.launch_counts()
    assert counts["trtri_block_f32"] > 0 and counts["gemm_f32"] > 0
    ref = ct.trsm(side, uplo, trans, diag, 0.5, A, B.double(), backend="ref")
    assert_close(X, ref, 60 * n, f"trsm {side}{uplo}{trans}{diag}")


@pytest.mark.cuda
def test_gp_step_on_the_card_vs_cpu(cuda):
    # the same model through the kernels and through the CPU's torch tile
    g = torch.Generator().manual_seed(0)
    X = torch.rand(2048, 8, generator=g) * 2 - 1
    y = torch.sin(X.sum(1)) + 0.1 * torch.randn(2048, generator=g)
    p = gp.GPParams.init()
    nll, grads, info = gp.gp_nll_and_grads(p, X.to(cuda), y.to(cuda))
    nll_c, grads_c, info_c = gp.gp_nll_and_grads(p, X, y)
    assert int(info) == int(info_c) == 0
    assert_close(nll, nll_c, 50 * 2048, "nll")
    for a, b in zip(grads, grads_c):
        assert_close(a, b, 3000 * 2048, "gradient")
