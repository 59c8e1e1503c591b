"""The port's CUDA kernels on the card, each against its plain torch twin,
and the f32 potrf, BLAS, d and c/z paths through them. Every test is
marked ``cuda`` and skips where torch sees no CUDA device.

A machine with a card need not have JAX installed, so this file imports
neither JAX nor tests/util.py, and the repo's tests/conftest.py (which
imports JAX) is bypassed there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The bound is tests/util.py's, restated: fpe x 2 x eps_f32 x max(1, |ref|),
with fpe 2k+3 for a product of depth k, 8n for a Cholesky factor, 60n
for a triangular inverse or solve and 3000n for potri. The dense gates
(F32_GATE below) are tighter: the block-cyclic tier's solves and potri
are held by them, since 60n and 3000n exceed the entries they check."""

import collections
import functools

import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu_torch.models import gp
from cholesky_tpu_torch.ops import blocked, kernels, ozaki
from cholesky_tpu_torch.ops.kernels import gemm, leaf, mega, syrk, trmm
from cholesky_tpu_torch.ops.kernels import ozaki as ozk
from cholesky_tpu_torch.ops.kernels import prng, rbf
from cholesky_tpu_torch.rng import (latmc, latmc_pair, uniform_device,
                                    uniform_device64)
from cholesky_tpu_torch.rng import device as rdev

# the blocked recursion's kernels, which potrf runs with a block size
POTRF_PATH = ("gemm_f32", "syrk_lower_f32", "potrf_stream_f32",
              "trtri_block_f32")
# the d tier's kernels, which dpotrf runs on the card
D_PATH = ("peel_f64", "mm_groups_f64", "potrf_block_f32",
          "trtri_block_f32")

EPS32 = float(np.finfo(np.float32).eps)
#: the dense gates: the error against f64 at most this many times an f32
#: yardstick's (the twin, or torch.matmul), and for a factor that limit
#: below 1 % of the RMS of the f64 factor's strict lower, which a dropped
#: or misplaced update tile moves by about itself
F32_GATE = 8.0


def assert_close(got, ref, fpe, what):
    wide = torch.complex128 if got.is_complex() or ref.is_complex() \
        else torch.float64
    got = got.to(wide).cpu()
    ref = ref.to(wide).cpu()
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


@pytest.fixture(params=[False, True], ids=["one", "many"])
def multi(request, monkeypatch):
    """potrf_block_f32 on one thread block or on many, whatever n: the
    crossover POTRF_BLOCK_MULTI_MIN_N is the only selector."""
    monkeypatch.setattr(mega, "POTRF_BLOCK_MULTI_MIN_N",
                        1 if request.param else mega.MAX_N + 1)
    return request.param


@pytest.fixture(params=[128, 64], ids=["tile128", "tile64"])
def gemm_tile(request, monkeypatch):
    """gemm_f32 on the 128 or the 64 tile whatever the shape: the threshold
    GEMM128_MIN_TILES is the only selector."""
    monkeypatch.setattr(gemm, "GEMM128_MIN_TILES",
                        1 if request.param == 128 else 1 << 30)
    return request.param


def view(rows, cols, transposed, off, odd, seed):
    """A (rows x cols) f32 view of a wider buffer on the card, row- or
    column-major, ``off`` elements past an aligned base, the leading
    stride a multiple of 4 or (``odd``) odd."""
    inner, outer = (rows, cols) if transposed else (cols, rows)
    width = inner + off + 1
    width += (width % 2 == 0) if odd else -width % 4
    v = rand((outer, width), seed).cuda()[:, off:off + inner]
    return v.T if transposed else v


@pytest.mark.cuda
@pytest.mark.parametrize("a_t", [False, True], ids=["AN", "AT"])
@pytest.mark.parametrize("b_t", [False, True], ids=["BN", "BT"])
@pytest.mark.parametrize("off,odd", [(0, False), (1, False), (0, True)],
                         ids=["grid", "off", "odd"])
def test_gemm_layouts_vs_f64(cuda, gemm_tile, a_t, b_t, off, odd):
    # ragged m, n, k; the four layouts; on and off the 16-byte grid
    m, n, k = 1000, 777, 515
    A, B = view(m, k, a_t, off, odd, 1), view(k, n, b_t, off, odd, 2)
    plan = gemm.launch_plan(m, n, A.stride(), A.data_ptr(), B.stride(),
                            B.data_ptr())
    assert plan[0] == gemm_tile and plan[3] == (off == 0 and not odd)
    ref = A.double() @ B.double()
    err = float((kernels.gemm_f32(A, B) - ref).abs().max())
    yard = float((torch.matmul(A, B) - ref).abs().max())
    assert err <= F32_GATE * yard, (err, yard)


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
@pytest.mark.parametrize("row_fast", [False, True], ids=["kfast", "rowfast"])
@pytest.mark.parametrize("cut", [{}, {"split": 1}, {"split": 2},
                                 {"split": 3}, {"blocks": 97},
                                 {"blocks": 264}],
                         ids=["rule", "whole", "split2", "split3",
                              "blocks97", "blocks264"])
def test_syrk_plans(cuda, monkeypatch, row_fast, cut):
    # every cut of the depth on both layouts of A, off the 16-byte grid,
    # into a view of C: the strict upper and the rest of the buffer kept,
    # a second call equal bit for bit
    monkeypatch.setattr(syrk, "launch_plan",
                        functools.partial(syrk.launch_plan, **cut))
    n, k = 1000, 777
    if row_fast:
        A = rand((k, n + 1), 9).to(cuda)[:, 1:].mH
    else:
        A = rand((n, k + 1), 9).to(cuda)[:, 1:]
    W = rand((n, n + 3), 10).to(cuda)
    W0 = W.clone()
    C = W[:, 1:1 + n]
    want = syrk.syrk_lower_plain(-1.0, A, 1.0, C.clone())
    kernels.syrk_lower_f32(-1.0, A, 1.0, C)
    again = W0.clone()
    kernels.syrk_lower_f32(-1.0, A, 1.0, again[:, 1:1 + n])
    assert torch.equal(W, again)
    assert_close(torch.tril(C), torch.tril(want), 2 * k + 3, f"syrk {cut}")
    low = torch.ones(n, n, dtype=torch.bool, device=cuda).tril_()
    assert torch.equal(C[~low], W0[:, 1:1 + n][~low])
    assert torch.equal(W[:, 0], W0[:, 0])
    assert torch.equal(W[:, 1 + n:], W0[:, 1 + n:])


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
@pytest.mark.parametrize("n", [1, 31, 33, 127, 128, 129, 200, 512, 777,
                               1024])
def test_potrf_block_launches_on_views(cuda, n, multi):
    # both launches on a view of a wider buffer whose strict upper holds
    # NaN: the lower read, the strict upper zeroed, nothing else written
    A = spd(n, seed=n).to(cuda)
    want = A.clone()
    i_ref = mega.potrf_block_plain(want)
    buf = torch.full((n, n + 24), 7.0, device=cuda)
    v = buf[:, 8:8 + n]
    v.copy_(A)
    v[torch.ones_like(v, dtype=torch.bool).triu(1)] = float("nan")
    info = kernels.potrf_block_f32(v)
    assert int(info) == int(i_ref) == 0
    assert_close(v, want, 8 * n, f"potrf_block n={n} multi={multi}")
    assert bool((torch.triu(v, 1) == 0).all())
    assert bool((buf[:, :8] == 7.0).all() and (buf[:, 8 + n:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,value", [(256, 4, -1.0), (1024, 100, -1.0),
                                       (1024, 1000, -1.0), (777, 776, -1.0),
                                       (512, 300, "nan"), (256, 7, "nan")])
def test_potrf_block_failed_pivot_panels(cuda, n, k, value, multi):
    # a failed pivot in the first, a later and the last panel, and NaN
    # pivots: info, nothing non-finite but an input NaN at its own place,
    # the leading block the twin's
    A = spd(n, cond=10.0, seed=k).to(cuda)
    A[k, k] = float(value)
    want = A.clone()
    i_ref = mega.potrf_block_plain(want)
    info = kernels.potrf_block_f32(A)
    assert int(info) == int(i_ref) == k + 1
    bad = (~torch.isfinite(A)).nonzero().tolist()
    assert all(ix == [k, k] for ix in bad), bad[:5]
    assert_close(torch.tril(A[:k, :k]), torch.tril(want[:k, :k]), 8 * n,
                 f"leading block n={n} k={k}")


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


def gated(what, got, ref64, twin, rms=None):
    """got against the f64 ``ref64`` within F32_GATE times the f32 ``twin``'s
    error (at least an ulp of max|ref|); the limit below 1 % of ``rms``
    (default: the RMS of ref64's strict lower); complex in c128."""
    wide = torch.complex128 if ref64.is_complex() else torch.float64
    ref64 = ref64.cpu().to(wide)
    err = float((got.cpu().to(wide) - ref64).abs().max())
    twin_err = float((twin.cpu().to(wide) - ref64).abs().max())
    lim = F32_GATE * max(twin_err, EPS32 * float(ref64.abs().max()))
    if rms is None:
        low = torch.tril(ref64, -1).abs()
        n = ref64.shape[0]
        rms = float(low.square().sum().div(max(1, n * (n - 1) // 2)).sqrt())
    assert err <= lim, f"{what}: err {err:.3e} > {lim:.3e}"
    assert lim <= 1e-2 * rms, f"{what}: limit {lim:.3e}, RMS {rms:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1152, 2048, 4096, 8192])
def test_potrf_stream_vs_twin(cuda, n):
    # a dense input, the caller's strict upper NaN: only the lower is read
    A = spd(n, seed=n).to(cuda)
    want = A.clone()
    i_ref = mega.potrf_stream_plain(want)
    L64 = torch.linalg.cholesky(A.double())
    A[torch.ones_like(A, dtype=torch.bool).triu(1)] = float("nan")
    info = kernels.potrf_stream_f32(A)
    assert int(info) == int(i_ref) == 0
    assert bool((torch.triu(A, 1) == 0).all())
    gated(f"potrf_stream n={n}", A, L64, want)


@pytest.mark.cuda
def test_potrf_stream_on_a_view_off_the_grid(cuda):
    # base one column into a buffer of odd row length: neither the base nor
    # the leading stride on the 16-byte grid; nothing outside written
    n = 2048
    A = spd(n, seed=3).to(cuda)
    want = A.clone()
    mega.potrf_stream_plain(want)
    buf = torch.full((n, n + 3), 7.0, device=cuda)
    v = buf[:, 1:1 + n]
    v.copy_(A)
    assert int(kernels.potrf_stream_f32(v)) == 0
    gated("potrf_stream view", v, torch.linalg.cholesky(A.double()), want)
    assert bool((buf[:, 0] == 7.0).all() and (buf[:, 1 + n:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,value", [(5, -1.0), (1000, -1.0), (2040, -1.0),
                                     (7, "nan")])
def test_potrf_stream_failed_pivots(cuda, k, value):
    # the first, a middle and the last panel, and a NaN pivot: info, frozen
    # and finite but an input NaN at its place, the leading block gated
    A = spd(2048, cond=10.0, seed=k).to(cuda)
    A[k, k] = float(value)
    want = A.clone()
    i_ref = mega.potrf_stream_plain(want)
    L64 = torch.linalg.cholesky(A[:k, :k].double())
    assert int(kernels.potrf_stream_f32(A)) == int(i_ref) == k + 1
    bad = (~torch.isfinite(A)).nonzero().tolist()
    assert all(ix == [k, k] for ix in bad), bad[:5]
    gated(f"potrf_stream leading block k={k}", torch.tril(A[:k, :k]), L64,
          torch.tril(want[:k, :k]))


@pytest.mark.cuda
def test_potrf_stream_trace(cuda):
    # the trace: block 0's stamps of each panel in order, the grid size
    n = 1024
    tr = torch.zeros(n // mega.NB, mega.STREAM_TRACE_SLOTS,
                     dtype=torch.int64, device=cuda)
    assert int(kernels.potrf_stream_f32(spd(n).to(cuda), trace=tr)) == 0
    t = tr.cpu()
    assert int(t[0, 1]) >= 1
    order = t[1:, [0, 2, 3, 4, 5, 7]]
    assert bool((order[:, 1:] >= order[:, :-1]).all())
    assert bool((t[2:, 0] >= t[1:-1, 7]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,uplo", [(1000, "L"), (1536, "U"), (2048, "L")])
def test_potrf_main_path(cuda, n, uplo):
    # one whole-matrix kernel on the block padded to a multiple of 128
    # (1000 to 1024): potrf_stream_f32 from 512, potrf_block_f32 below;
    # where the tuning table in force caps potrf below the block, the
    # recursion, whose diagonal blocks go to the same kernel
    A = spd(n)
    kernels.reset_launch_counts()
    F, info = ct.potrf(uplo, A.to(cuda))
    assert int(info) == 0
    counts = kernels.launch_counts()
    p = -(-n // 128) * 128
    stream = p >= mega.POTRF_STREAM_MIN_N
    kernel = "potrf_stream_f32" if stream else "potrf_block_f32"
    if blocked._mega_ok(p):
        assert counts[kernel] == 1, counts
        assert counts["gemm_f32"] == counts["syrk_lower_f32"] == 0, counts
    else:
        assert all(counts[k] > 0 for k in (kernel, "gemm_f32",
                                           "syrk_lower_f32")), counts
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


def dense_factor(n, seed):
    """A dense f32 Cholesky factor on the card: of G·Gᵀ/n + I/25, G
    Gaussian, so every entry of it and of its inverse is live."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn(n, n, device="cuda", generator=g)
    A = (G @ G.T).div_(n)
    A.diagonal().add_(0.04)
    return torch.linalg.cholesky(A.double()).float().contiguous()


def gate(got, ref64, yard32, what):
    """got within F32_GATE times an f32 yardstick's error against the f64
    ref64 (at least an ulp of max|ref64|)."""
    err = float((got.double() - ref64).abs().max())
    yard = float((yard32.double() - ref64).abs().max())
    lim = F32_GATE * max(yard, EPS32 * float(ref64.abs().max()))
    assert err <= lim, f"{what}: err {err:.3e} > {lim:.3e}"


def nan_upper(L):
    X = L.clone()
    X[torch.ones_like(X, dtype=torch.bool).triu(1)] = float("nan")
    return X


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1024, 1152, 8192])
@pytest.mark.parametrize("whole_min", [None, 1, 1 << 30],
                         ids=["rule", "whole", "runs"])
def test_trtri_stream_dense_vs_f64(cuda, monkeypatch, n, whole_min):
    # the leaves and every level, a tile a block or in runs, with a NaN
    # strict upper, repeated bit for bit
    if whole_min is not None:
        monkeypatch.setattr(mega, "STREAM_WHOLE_MIN_TILES", whole_min)
    L = dense_factor(n, 3)
    X = nan_upper(L)
    W, info = kernels.trtri_stream_f32(X)
    again, _ = kernels.trtri_stream_f32(X)
    assert int(info) == 0 and torch.equal(W, again)
    assert bool((torch.triu(W, 1) == 0).all())
    eye = torch.eye(n, device=cuda)
    gate(W, torch.linalg.solve_triangular(L.double(), eye.double(),
                                          upper=False),
         torch.linalg.solve_triangular(L, eye, upper=False),
         f"trtri_stream n={n} whole_min {whole_min}")


@pytest.mark.cuda
def test_trtri_stream_zero_diagonals_and_unit(cuda):
    # zeros at 9, 700 and 1200: info the smallest, read as 1, finite, as
    # the twin; the unit form through unit_inverse, its diagonal passed
    # through
    L = dense_factor(2048, 4)
    Z = L.clone()
    for z in (9, 700, 1200):
        Z[z, z] = 0.0
    W, info = kernels.trtri_stream_f32(Z)
    want, i_ref = mega.trtri_stream_plain(Z)
    assert int(info) == int(i_ref) == 10 and bool(torch.isfinite(W).all())
    assert_close(W, want, 60 * 2048, "trtri_stream zero diagonals")
    U = L[:1152, :1152] / torch.diagonal(L)[None, :1152]
    U.diagonal().copy_(torch.diagonal(L)[:1152])
    W, info = leaf.unit_inverse(kernels.trtri_stream_f32, U)
    assert int(info) == 0
    assert torch.equal(torch.diagonal(W), torch.diagonal(U))
    eye = torch.eye(1152, device=cuda)
    gate(torch.tril(W, -1),
         torch.tril(torch.linalg.solve_triangular(
             U.double(), eye.double(), upper=False, unitriangular=True), -1),
         torch.tril(torch.linalg.solve_triangular(
             U, eye, upper=False, unitriangular=True), -1),
         "trtri_stream unit")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1024, 1152, 8192])
@pytest.mark.parametrize("cut", [{}, {"whole": True}, {"blocks": 264}],
                         ids=["rule", "whole", "runs"])
def test_lauum_stream_dense_vs_f64(cuda, monkeypatch, n, cut):
    # the plan's runs or a tile a block, with a NaN strict upper, repeated
    # bit for bit
    monkeypatch.setattr(mega, "lauum_launch_plan",
                        functools.partial(mega.lauum_launch_plan, **cut))
    L = torch.tril(dense_factor(n, 5))
    X = nan_upper(L)
    B = kernels.lauum_stream_f32(X)
    assert torch.equal(B, kernels.lauum_stream_f32(X))
    assert bool(torch.isfinite(B).all())
    assert bool((torch.triu(B, 1) == 0).all())
    gate(B, torch.tril(L.double().T @ L.double()), torch.tril(L.T @ L),
         f"lauum_stream n={n} {cut}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,off,extra", [(1152, 5, 37), (2048, 128, 128)])
def test_lauum_stream_on_a_view(cuda, n, off, extra):
    # a row longer than n, off and on the 16-byte grid, NaN around the
    # lower triangle
    L = torch.tril(dense_factor(n, 6))
    buf = torch.full((n, n + extra), float("nan"), device=cuda)
    v = buf[:, off:off + n]
    v.copy_(L + torch.triu(v, 1))
    B = kernels.lauum_stream_f32(v)
    gate(B, torch.tril(L.double().T @ L.double()), torch.tril(L.T @ L),
         f"lauum_stream view n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 100, 129, 368, 512, 1000, 2048])
@pytest.mark.parametrize("layout", ["contiguous", "on_grid", "off_grid"])
@pytest.mark.parametrize("plan", [{}, {"whole": True}],
                         ids=["rule", "whole"])
def test_lauu2_vs_twin(cuda, monkeypatch, n, layout, plan):
    # a dense factor under a NaN strict upper of many payloads, as a
    # contiguous leaf or a leaf of a wider buffer on or off the 16-byte
    # grid with NaN around it; the upper comes back bit for bit
    if plan:
        monkeypatch.setattr(leaf, "lauu2_launch_plan", functools.partial(
            mega.lauum_launch_plan, **plan))
    L = torch.tril(dense_factor(n, 5))
    g = torch.Generator(device="cuda").manual_seed(n)
    bits = torch.randint(1, 1 << 22, (n, n), device=cuda, generator=g,
                         dtype=torch.int32) | 0x7F800000
    bits[::2] |= -(1 << 31)
    up = torch.ones(n, n, dtype=torch.bool, device=cuda).triu(1)
    if layout == "contiguous":
        A = torch.empty_like(L)
    else:
        off, width = (4, -(-(n + 8) // 4) * 4) if layout == "on_grid" \
            else (5, (n + 8) | 1)
        A = torch.full((n, width), float("nan"), device=cuda)[:, off:off + n]
    A.copy_(torch.where(up, bits.view(torch.float32), L))
    before = kernels.launch_counts()["lauu2_f32"]
    B = kernels.lauu2_f32(A)
    assert kernels.launch_counts()["lauu2_f32"] == before + 1
    assert B.is_contiguous() and B.shape == (n, n)
    gate(torch.tril(B), torch.tril(L.double().T @ L.double()),
         torch.tril(leaf.lauu2_plain(L)), f"lauu2 n={n} {layout}")
    assert torch.equal(B.view(torch.int32)[up], A.view(torch.int32)[up])
    assert torch.equal(B.view(torch.int32),
                       kernels.lauu2_f32(A).view(torch.int32))


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
        if blocked._mega_ok(n, "trtri"):
            # one whole-matrix inverse under the tuning table in force
            assert counts["trtri_stream_f32"] == 1, counts
            assert counts["gemm_f32"] == 0, counts
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
    # the leaves are the tuning table's leaf_nb (one leaf of the padded
    # block when it is larger than n), inverted whole
    nb = blocked._KernelTiles().default_nb
    leaf = min(nb, -(-n // nb) * nb)
    kernel = ("trtri_block_f32" if leaf <= mega.MAX_N else
              "trtri_stream_f32" if blocked._mega_ok(leaf, "trtri") else
              "trti2_f32")
    assert counts[kernel] > 0 and counts["gemm_f32"] > 0, counts
    ref = ct.trsm(side, uplo, trans, diag, 0.5, A, B.double(), backend="ref")
    assert_close(X, ref, 60 * n, f"trsm {side}{uplo}{trans}{diag}")


@pytest.mark.cuda
def test_gp_step_on_the_card_vs_cpu(cuda):
    # the same model through the kernels and through the CPU's torch tile
    g = torch.Generator().manual_seed(0)
    X = torch.rand(2048, 8, generator=g) * 2 - 1
    y = torch.sin(X.sum(1)) + 0.1 * torch.randn(2048, generator=g)
    p = gp.GPParams.init()              # on the card unless told otherwise
    assert all(v.device.type == "cuda" for v in p)
    nll, grads, info = gp.gp_nll_and_grads(p, X.to(cuda), y.to(cuda))
    nll_c, grads_c, info_c = gp.gp_nll_and_grads(
        gp.GPParams.init(device="cpu"), X, y)
    assert int(info) == int(info_c) == 0
    assert_close(nll, nll_c, 50 * 2048, "nll")
    for a, b in zip(grads, grads_c):
        assert_close(a, b, 3000 * 2048, "gradient")


# ---------------------------------------------------------------------------
# the GP model's RBF kernels: rbf_f32 and rbf_grad_f32
# ---------------------------------------------------------------------------

#: rbf_f32's K against the twin's: D is equal bit for bit, and -0.5·D,
#: /ell2 and amp· are correctly rounded in both, so only exp may differ:
#: CUDA's expf is within 2 ulp of exp, and torch's CUDA exp and the
#: kernel's expf may come from different builds of the math library
K_ULPS = 2


def ulps(a, b):
    """|a − b| in units in the last place, a and b float32 of one sign:
    the distance of their bit patterns."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def rbf_params(dtype=torch.float32, device="cuda"):
    return gp.GPParams(*(torch.tensor(v, dtype=dtype, device=device)
                         for v in (0.3, -0.2, -1.0)))


def rbf_points(n, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(n, d, device="cuda", generator=g) * 2.0 - 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (7, 7), (128, 128), (1000, 1000),
                                 (8192, 819)])
@pytest.mark.parametrize("d", [1, 8, 13])
@pytest.mark.parametrize("form", ["x2", "same", "diag"])
def test_rbf_vs_twin(cuda, n, m, d, form):
    # X2 ≠ X1 (n x m), X2 = X1 (the lower tiles and their mirrors), and
    # X2 = X1 with (noise + jitter) on the diagonal
    p = rbf_params()
    X1 = rbf_points(n, d, n + d)
    X2 = rbf_points(m, d, m + d + 1) if form == "x2" else X1
    noise = (p.log_noise,) if form == "diag" else ()
    kernels.reset_launch_counts()
    D = rbf.sqdist_f32(X1, X2)
    assert torch.equal(D, rbf.sqdist_plain(X1, X2))
    K = rbf.rbf_f32(X1, X2, p.log_amp, p.log_len, *noise, jitter=1e-6)
    want = rbf.rbf_plain(X1, X2, p.log_amp, p.log_len, *noise, jitter=1e-6)
    assert K.shape == want.shape and bool((K > 0).all())
    worst = int(ulps(K, want).max())
    assert worst <= K_ULPS, f"K {worst} ulps from the twin's"
    assert kernels.launch_counts()["rbf_f32"] == 2
    if form != "x2":
        assert torch.equal(K, K.T)
    assert torch.equal(rbf.rbf_f32(X1, X2, p.log_amp, p.log_len, *noise,
                                   jitter=1e-6), K)


def rbf_grad_inputs(n, d, seed):
    """X, α and K⁻¹'s lower triangle of a GP on the card, as the model's
    train step makes them."""
    p = rbf_params()
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand(n, d, device="cuda", generator=g) * 2.0 - 1.0
    y = torch.sin(3.0 * X.sum(1)) + 0.1 * torch.randn(n, device="cuda",
                                                       generator=g)
    F, info = ct.potrf("L", gp._kmatrix(p, X))
    assert int(info) == 0
    z = ct.trsm("L", "L", "N", "N", 1.0, F, y[:, None])
    alpha = ct.trsm("L", "L", "T", "N", 1.0, F, z)[:, 0]
    return p, X, alpha, ct.potri("L", F)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 1), (7, 13), (300, 8), (2048, 8),
                                 (8192, 8)])
def test_rbf_grad_vs_twin_and_f64(cuda, n, d):
    # The twin rounds W, kf and each product as the kernel does and only
    # sums in another order, so both stand at about the same distance from
    # the f64 evaluation of the same W and K. The log_amp sum cancels terms
    # of about n, so that distance is measured against the sum's scale
    # Σ|terms|: the kernel within 8 times the twin's error, or within eps
    # of Σ|terms| where the twin's is smaller by chance. A tile added or
    # left out moves a sum by about 1/tiles of Σ|terms|, far above both.
    p, X, alpha, Kinv_tri = rbf_grad_inputs(n, d, n)
    kernels.reset_launch_counts()
    got = rbf.rbf_grad_f32(Kinv_tri, alpha, X, *p)
    assert kernels.launch_counts()["rbf_grad_f32"] == 1
    twin = rbf.rbf_grad_plain(Kinv_tri, alpha, X, *p)
    p64 = [v.double() for v in p]
    ref = rbf.rbf_grad_plain(Kinv_tri.double(), alpha.double(), X.double(),
                             *p64)
    Kinv = torch.tril(Kinv_tri.double())
    Kinv = Kinv + torch.tril(Kinv, -1).T
    W = Kinv - alpha.double()[:, None] * alpha.double()[None, :]
    Dm = rbf.sqdist_plain(X.double(), X.double())
    ell2 = torch.exp(2.0 * p64[1])
    Kf = torch.exp(2.0 * p64[0]) * torch.exp(-0.5 * Dm / ell2)
    scales = (float((W * 2.0 * Kf).abs().sum()),
              float((W * Kf * Dm / ell2).abs().sum()),
              float(W.diagonal().abs().sum() * torch.exp(2.0 * p64[2])))
    for name, a, t, r, scale in zip(gp.GPParams._fields, got, twin, ref,
                                    scales):
        assert a.dtype == torch.float32 and a.ndim == 0
        err, err_t = abs(float(a) - float(r)), abs(float(t) - float(r))
        lim = max(8.0 * err_t, EPS32 * scale)
        assert err <= lim, (f"{name}: err {err:.3e} > {lim:.3e} (twin "
                            f"{err_t:.3e}, scale {scale:.3e})")
    # two runs, the same bits; nothing above the diagonal is read
    dirty = torch.tril(Kinv_tri) + torch.full_like(Kinv_tri,
                                                   float("nan")).triu(1)
    again = rbf.rbf_grad_f32(dirty, alpha, X, *p)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_gp_takes_the_rbf_kernels_only_in_f32(cuda):
    g = torch.Generator(device="cuda").manual_seed(3)
    X = torch.rand(300, 8, device="cuda", generator=g) * 2.0 - 1.0
    y = torch.sin(X.sum(1))
    Xs = X[:31] * 0.5
    kernels.reset_launch_counts()
    gp.gp_train_step(rbf_params(), X, y)
    gp.gp_predict(rbf_params(), X, y, Xs)
    counts = kernels.launch_counts()
    assert counts["rbf_f32"] == 4 and counts["rbf_grad_f32"] == 1, counts
    kernels.reset_launch_counts()
    p64 = rbf_params(torch.float64)
    gp.gp_train_step(p64, X.double(), y.double())
    gp.gp_predict(p64, X.double(), y.double(), Xs.double())
    counts = kernels.launch_counts()
    assert counts["rbf_f32"] == counts["rbf_grad_f32"] == 0, counts


@pytest.mark.cuda
def test_gp_model_adds_no_host_sync(cuda, monkeypatch):
    # a train step and a prediction under sync_debug_mode "error", the
    # library's calls let through: the model's own work, the RBF kernels
    # included, never waits for the card
    real = gp.ops

    def let_through(fn):
        def call(*args, **kwargs):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    monkeypatch.setattr(gp, "ops", type("Ops", (), {
        name: staticmethod(let_through(getattr(real, name)))
        for name in ("potrf", "logdet_from_factor", "trsm", "potri")}))
    g = torch.Generator(device="cuda").manual_seed(4)
    X = torch.rand(1000, 8, device="cuda", generator=g) * 2.0 - 1.0
    y = torch.sin(X.sum(1))
    p = rbf_params()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, nll, info = gp.gp_train_step(p, X, y, lr=1e-4)
        mean, var, info_p = gp.gp_predict(p, X, y, X[:100])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(info) == int(info_p) == 0
    assert bool(torch.isfinite(nll)) and bool(torch.isfinite(var).all())


# ---------------------------------------------------------------------------
# the d tier: the two Ozaki kernels and the f64 drivers through them
# ---------------------------------------------------------------------------

def pair(shape, seed):
    """An exact f32 pair of values in [-1/2, 1/2], as split_rows makes."""
    x = np.random.default_rng(seed).uniform(-0.5, 0.5, shape)
    rh = x.astype(np.float32)
    return (torch.from_numpy(rh),
            torch.from_numpy((x - rh.astype(np.float64)).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,view", [(1, 1, "rows"), (37, 129, "rows"),
                                      (64, 260, "rows"),
                                      (200, 300, "transposed"),
                                      (130, 250, "sub-block")])
@pytest.mark.parametrize("slices", [4, 6])
def test_peel_vs_twin(cuda, m, k, view, slices):
    # ragged widths, the 16-byte loads (64 x 260), and strided inputs
    rh, rl = (t.to(cuda) for t in pair((m + 3, k + 5), 10))
    if view == "transposed":                 # as matmul_f64 peels B.T
        rh, rl = (t[:m, :k].T.contiguous().T for t in (rh, rl))
    elif view == "sub-block":                # an offset view of a wider one
        rh, rl = rh[3:, 5:], rl[3:, 5:]
    else:
        rh, rl = rh[:m, :k].contiguous(), rl[:m, :k].contiguous()
    got = ozk.peel_f32pair(rh, rl, slices=slices)
    want = ozk.peel_plain(rh, rl, slices)
    assert got.shape == want.shape == (slices, rh.shape[0], rh.shape[1])
    assert torch.equal(got, want)            # bit for bit
    assert got.stride(1) % ozk.ALIGN == 0 and got.stride(2) == 1


def peel_pair(A, B, slices=6):
    As, _ = ozaki.split_rows(A, slices)
    Bs, _ = ozaki.split_rows(B.T, slices)
    return As, Bs


def assert_groups_close(As, Bs, atol=None):
    hi, lo = kernels.mm_groups_f32pair(As, Bs)
    rh, rl = ozk.mm_groups_plain(As, Bs)
    got, ref = hi.double() + lo.double(), rh.double() + rl.double()
    err = float((got - ref).abs().max())
    bound = 1e-12 * float(ref.abs().max()) if atol is None else atol
    assert err <= bound, f"max abs diff {err:.3e} > {bound:.3e}"
    # a renormalized pair: |lo| <= ulp(hi) / 2
    assert bool((lo.abs() <= torch.nextafter(hi.abs(), torch.tensor(
        float("inf"), device=hi.device)) - hi.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(192, 160, 640), (1, 1, 1), (77, 130, 1000),
                                   (64, 64, 33), (16, 24, 40000),
                                   (1100, 1100, 33000)])
def test_mm_groups_vs_twin(cuda, m, n, k):
    # k over many 32-wide steps, a ragged k end, ragged m and n, and k past
    # the kernel's exact int32 chunk on both tile widths
    g = torch.Generator().manual_seed(m + n + k)
    A = torch.randn(m, k, generator=g, dtype=torch.float64) * torch.exp(
        2.0 * torch.randn(m, k, generator=g, dtype=torch.float64))
    B = torch.randn(k, n, generator=g, dtype=torch.float64)
    assert_groups_close(*peel_pair(A.to(cuda), B.to(cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 4, 6, 8])
@pytest.mark.parametrize("m,n,k,off", [(64, 64, 32, 0), (130, 77, 333, 0),
                                       (200, 300, 1000, 40), (65, 1, 17, 3),
                                       (2000, 600, 333, 5)])
def test_mm_groups_slices_and_offsets(cuda, slices, m, n, k, off):
    # every slice count the kernel takes, ragged m, n and k, operands at k
    # offsets off the 16-byte grid (copied to aligned rows first), and a
    # grid large enough for the 64 x 128 tiles (S <= 6)
    g = torch.Generator().manual_seed(slices * 1000 + m)
    A = torch.randn(m, k + off, generator=g, dtype=torch.float64)
    B = torch.randn(n, k + off, generator=g, dtype=torch.float64)
    As, _ = ozaki.split_rows(A.to(cuda), slices)
    Bs, _ = ozaki.split_rows(B.to(cuda), slices)
    assert_groups_close(As[:, :, off:], Bs[:, :, off:])


@pytest.mark.cuda
def test_mm_groups_cancellation(cuda):
    # T = L·L⁻¹ ≈ I, the Newton step's product (tests/test_ozaki.py:305-322)
    n = 640
    r = np.random.default_rng(9)
    G = r.standard_normal((n, n))
    L = np.linalg.cholesky(G @ G.T + n * np.eye(n))
    W = np.linalg.inv(L)
    L, W = torch.from_numpy(L).to(cuda), torch.from_numpy(W).to(cuda)
    assert_groups_close(*peel_pair(L, W), atol=n * 2.0 ** -40)
    T = ozaki.matmul_f64(L, W, slices=6)
    assert float((T - L @ W).abs().max()) < n * 2.0 ** -40


@pytest.mark.cuda
def test_mm_groups_on_views_of_one_peel(cuda):
    # the hoisted recursions' operands: sub-blocks of one peel of a
    # triangle, at k offsets that are multiples of the block size
    n, i, n1 = 640, 128, 256
    L = torch.tril(torch.randn(n, n, dtype=torch.float64,
                               generator=torch.Generator().manual_seed(3)))
    Ls, lsc = ozaki.split_rows(L.to(cuda), 6)
    X = torch.randn(300, n1, dtype=torch.float64, device=cuda)
    Xs, xsc = ozaki.split_rows(X, 6)
    sub = Ls[:, i + n1:n, i:i + n1]
    assert not sub.is_contiguous()
    assert_groups_close(Xs, sub)
    assert_groups_close(sub, Xs)
    C = ozaki.matmul_presplit(Xs, xsc, sub, lsc[i + n1:n])
    ref = X @ L[i + n1:n, i:i + n1].to(cuda).T
    # the product itself: S = 6 drops the pairs below about k·2^-42 of the
    # row scales, which a sub-block takes from its full rows (the bound of
    # the JAX package's hoisted products, test_ozaki.py)
    assert float((C - ref).abs().max()) < 1e-9 * float(ref.abs().max())
    # a k offset off the 16-byte grid: the wrapper copies the rows into an
    # aligned buffer and the kernel runs
    kernels.reset_launch_counts()
    assert_groups_close(Ls[:, :64, 3:67], Ls[:, 64:128, 3:67])
    assert kernels.launch_counts()["mm_groups_f32pair"] == 1


@pytest.mark.cuda
def test_dpotrf_on_the_card(cuda):
    # f64 on the card goes to the d tier under auto, through both Ozaki
    # kernels and the f32 leaf kernels
    n = 1024
    A = torch.from_numpy(spd(n).double().numpy())
    A = 0.5 * (A + A.T)
    kernels.reset_launch_counts()
    F, info = ct.dpotrf("L", A.to(cuda))
    assert int(info) == 0
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in D_PATH), counts
    L = torch.tril(F).cpu()
    ref = torch.linalg.cholesky(A)
    assert float((L - ref).abs().max()) <= 1e-9 * float(ref.abs().max())
    assert float((L @ L.T - A).abs().max()) <= n * 2.0 ** -40 * float(
        A.abs().max())


@pytest.mark.cuda
def test_dlogdet_dpotri_dtrsm_on_the_card(cuda):
    n = 768
    A = spd(n, cond=30.0).double()
    A = 0.5 * (A + A.T)
    val, info = ct.dlogdet("L", A.to(cuda))
    ref = torch.linalg.slogdet(A)[1]
    assert int(info) == 0
    assert abs(float(val) - float(ref)) <= 1e-9 * abs(float(ref))
    L = torch.linalg.cholesky(A)
    inv, info = ct.dpotri("L", L.to(cuda))
    want = torch.cholesky_inverse(L)
    assert int(info) == 0
    err = float((torch.tril(inv.cpu()) - torch.tril(want)).abs().max())
    assert err <= 30.0 * n * 2.0 ** -40 * float(want.abs().max())
    B = torch.randn(n, 96, dtype=torch.float64)
    for trans in ("N", "T"):
        X = ct.dtrsm("L", "L", trans, "N", 1.0, L.to(cuda), B.to(cuda))
        M = L if trans == "N" else L.T
        assert float((M @ X.cpu() - B).abs().max()) <= 1e-9 * float(
            B.abs().max())


@pytest.mark.cuda
def test_hoisted_drivers_with_block_size_40_on_the_card(cuda):
    # the hoisted peel sliced at k offsets 40, 80, ...: the wrapper realigns
    # those rows and the kernel runs
    n = 200
    A = spd(n, cond=30.0).double()
    A = 0.5 * (A + A.T)
    kernels.reset_launch_counts()
    F, info = ct.dpotrf("L", A.to(cuda), block_size=40)
    assert int(info) == 0
    assert all(kernels.launch_counts()[k] > 0 for k in D_PATH)
    L = torch.linalg.cholesky(A)
    assert float((torch.tril(F).cpu() - L).abs().max()) <= 1e-9 * float(
        L.abs().max())
    B = torch.randn(n, 24, dtype=torch.float64)
    for trans in ("N", "T"):
        X = ct.dtrsm("L", "L", trans, "N", 1.0, L.to(cuda), B.to(cuda),
                     block_size=40)
        M = L if trans == "N" else L.T
        assert float((M @ X.cpu() - B).abs().max()) <= 1e-9 * float(
            B.abs().max())


@pytest.mark.cuda
def test_dpotrf_failures_on_the_card(cuda):
    # PD in f64, singular in f32: the second pass's f64 rescue gives info 0
    a = 0.5
    A = torch.tensor([[1.0, a], [a, a * a + 1e-12]], dtype=torch.float64)
    F, info = ct.dpotrf("L", A.to(cuda))
    assert int(info) == 0 and bool(torch.isfinite(F).all())
    # non-PD: the first failing pivot, the leading block finite
    A = spd(1024).double()
    A = 0.5 * (A + A.T)
    A[700, 700] = -1.0
    F, info = ct.dpotrf("L", A.to(cuda))
    assert int(info) == 701
    assert bool(torch.isfinite(F[:700, :700]).all())


# ---------------------------------------------------------------------------
# the leaf kernels, the trmm kernel and the BLAS entry points through them
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 100, 128, 384, 2048])
def test_potf2_vs_twin(cuda, n):
    A = spd(n).to(cuda)
    want = A.clone()
    i_ref = leaf.potf2_plain(want)
    A[torch.ones_like(A, dtype=torch.bool).triu(1)] = float("nan")
    info = kernels.potf2_f32(A)
    assert int(info) == int(i_ref) == 0
    assert bool((torch.triu(A, 1) == 0).all())
    assert_close(A, want, 8 * n, f"potf2 n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,value", [(2048, 1000, -1.0), (384, 7, "nan"),
                                       (100, 40, -3.0), (384, 300, 0.0)])
def test_potf2_failed_pivots(cuda, n, k, value):
    # info, the factor frozen at the failure: finite but an input NaN, and
    # the leading block right
    A = spd(n, cond=10.0).to(cuda)
    A[k, k] = float(value)
    want = A.clone()
    i_ref = leaf.potf2_plain(want)
    info = kernels.potf2_f32(A)
    assert int(info) == int(i_ref) == k + 1
    bad = (~torch.isfinite(A)).nonzero().tolist()
    assert all(ix == [k, k] for ix in bad), bad
    assert_close(A[:k, :k], want[:k, :k], 8 * n, "potf2 leading block")


@pytest.fixture(params=[128, 256, 512], ids=["kb128", "kb256", "kb512"])
def potf2_kb(request, monkeypatch):
    """potf2_f32's strip width, set for the test."""
    monkeypatch.setattr(leaf, "POTF2_KB", request.param)
    return request.param


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 256, 1024, 2048])
def test_potf2_strips_vs_f64(cuda, n, potf2_kb):
    # dense, the strict upper NaN; gated on the twin's error against f64
    A = spd(n, seed=n + potf2_kb).to(cuda)
    want = A.clone()
    i_ref = leaf.potf2_plain(want)
    L64 = torch.linalg.cholesky(A.double())
    A[torch.ones_like(A, dtype=torch.bool).triu(1)] = float("nan")
    info = kernels.potf2_f32(A)
    assert int(info) == int(i_ref) == 0
    assert bool((torch.triu(A, 1) == 0).all())
    gated(f"potf2 n={n} kb={potf2_kb}", A, L64, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,value", [(5, -1.0), (600, -1.0), (1020, -1.0),
                                     (300, "nan")])
def test_potf2_strips_failed_pivots(cuda, k, value, potf2_kb):
    # the first, a middle and the last strip, and a NaN pivot: info, finite
    # but an input NaN at its place, the leading block gated
    A = spd(1024, cond=10.0, seed=k).to(cuda)
    A[k, k] = float(value)
    want = A.clone()
    i_ref = leaf.potf2_plain(want)
    L64 = torch.linalg.cholesky(A[:k, :k].double())
    assert int(kernels.potf2_f32(A)) == int(i_ref) == k + 1
    bad = (~torch.isfinite(A)).nonzero().tolist()
    assert all(ix == [k, k] for ix in bad), bad[:5]
    gated(f"potf2 leading block k={k}", torch.tril(A[:k, :k]), L64,
          torch.tril(want[:k, :k]))


@pytest.mark.cuda
def test_potf2_on_a_view_off_the_grid(cuda):
    # the 128 tile's 4-byte staging: neither the base nor the leading
    # stride on the 16-byte grid; nothing outside the view written
    n = 2048
    A = spd(n, seed=4).to(cuda)
    want = A.clone()
    leaf.potf2_plain(want)
    buf = torch.full((n, n + 3), 7.0, device=cuda)
    v = buf[:, 1:1 + n]
    v.copy_(A)
    assert int(kernels.potf2_f32(v)) == 0
    gated("potf2 view", v, torch.linalg.cholesky(A.double()), want)
    assert bool((buf[:, 0] == 7.0).all() and (buf[:, 1 + n:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 128, 500, 512, 1000,
                               1024])
def test_trtri_block_dense_vs_f64(cuda, n):
    # a dense factor, the strict upper NaN: the block recursion's ragged
    # split points, gated on solve_triangular's f32 error against f64
    L = factor(n, seed=n).contiguous().to(cuda)
    X = L.clone()
    X[torch.ones_like(X, dtype=torch.bool).triu(1)] = float("nan")
    W, info = kernels.trtri_block_f32(X)
    assert int(info) == 0 and bool((torch.triu(W, 1) == 0).all())
    eye = torch.eye(n, device=cuda)
    W64 = torch.linalg.solve_triangular(L.double(), eye.double(), upper=False)
    yard = torch.linalg.solve_triangular(L, eye, upper=False)
    if n > 1:
        gated(f"trtri_block n={n}", W, W64, yard)
    else:
        assert_close(W, W64, 60, "trtri_block n=1")


@pytest.mark.cuda
def test_trtri_block_unit_and_view(cuda):
    # the unit route (leaf.unit_inverse) and a view with a longer row
    n = 500
    L = factor(n, seed=7).contiguous().to(cuda)
    U = L / torch.diagonal(L)[None, :] + torch.diag(torch.diagonal(L) - 1.0)
    W, info = leaf.unit_inverse(kernels.trtri_block_f32, U)
    want, _ = leaf.unit_inverse(mega.trtri_block_plain, U)
    assert int(info) == 0
    assert torch.equal(torch.diagonal(W), torch.diagonal(U))
    assert_close(W, want, 60 * n, "trtri_block unit")
    buf = torch.full((n, n + 37), 7.0, device=cuda)
    v = buf[:, 5:5 + n]
    v.copy_(L)
    W, info = kernels.trtri_block_f32(v)
    want, _ = mega.trtri_block_plain(L)
    assert int(info) == 0
    assert_close(W, want, 60 * n, "trtri_block view")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 100, 256, 1152])
@pytest.mark.parametrize("unit", [False, True])
def test_trti2_vs_twin(cuda, n, unit):
    L = factor(n).contiguous().to(cuda)
    if unit:        # a unit factor with a stored diagonal to pass through
        L = L / torch.diagonal(L)[None, :] + torch.diag(
            torch.diagonal(L) - 1.0)
    Lw = L.clone()
    Lw[torch.ones_like(Lw, dtype=torch.bool).triu(1)] = float("nan")
    W, info = kernels.trti2_f32(Lw, unit=unit)
    want, i_ref = leaf.trti2_plain(L, unit)
    assert int(info) == int(i_ref) == 0
    assert bool((torch.triu(W, 1) == 0).all())
    assert_close(W, want, 60 * n, f"trti2 n={n} unit={unit}")
    if unit:
        assert torch.equal(torch.diagonal(W), torch.diagonal(L))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [384, 640, 1280])
@pytest.mark.parametrize("unit", [False, True])
def test_trti2_odd_leaf_counts(cuda, n, unit):
    # 3, 5 and 10 leaves: levels with an unpaired block and a short C
    L = factor(n).contiguous().to(cuda)
    if unit:
        L = L / torch.diagonal(L)[None, :] + torch.diag(
            torch.diagonal(L) - 1.0)
    Lw = L.clone()
    Lw[torch.ones_like(Lw, dtype=torch.bool).triu(1)] = float("nan")
    W, info = kernels.trti2_f32(Lw, unit=unit)
    want, i_ref = leaf.trti2_plain(L, unit)
    assert int(info) == int(i_ref) == 0
    assert bool((torch.triu(W, 1) == 0).all())
    assert_close(W, want, 60 * n, f"trti2 n={n} unit={unit}")
    if unit:
        assert torch.equal(torch.diagonal(W), torch.diagonal(L))


@pytest.mark.cuda
def test_trti2_zero_diagonal(cuda):
    L = factor(384).contiguous().to(cuda)
    L[9, 9] = 0.0
    L[300, 300] = 0.0
    W, info = kernels.trti2_f32(L)
    want, i_ref = leaf.trti2_plain(L)
    assert int(info) == int(i_ref) == 10        # the smallest, as strtri
    assert bool(torch.isfinite(W).all())
    assert_close(W, want, 60 * 384, "trti2 zero diagonals")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(8, 8), (200, 130), (1000, 77), (1024, 1024)])
@pytest.mark.parametrize("upper,unit", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_trmm_lln_vs_twin(cuda, n, m, upper, unit):
    # upper runs on reversed views (pointers to the last rows, negated
    # strides); the other triangle, and with unit the diagonal, hold NaN
    L, B = rand((n, n), 11).to(cuda), rand((n, m), 12).to(cuda)
    want = trmm.trmm_lln_plain(L, B, 0.5, upper=upper, unit=unit)
    ones = torch.ones_like(L, dtype=torch.bool)
    read = ones.triu(int(unit)) if upper else ones.tril(-int(unit))
    L[~read] = float("nan")
    got = kernels.trmm_lln_f32(L, B, alpha=0.5, upper=upper, unit=unit)
    assert got.shape == (n, m) and bool(torch.isfinite(got).all())
    assert_close(got, want, 2 * n + 3, f"trmm_lln {n}x{m} {upper} {unit}")
    # strided views: L transposed, B a slice of a wider buffer
    Lt = rand((n, n), 13).T.contiguous().T.to(cuda)
    Bw = rand((n, m + 9), 14).to(cuda)
    got = kernels.trmm_lln_f32(Lt, Bw[:, 5:5 + m], upper=upper, unit=unit)
    want = trmm.trmm_lln_plain(Lt, Bw[:, 5:5 + m], upper=upper, unit=unit)
    assert_close(got, want, 2 * n + 3, f"trmm_lln views {n}x{m} {upper}")


@pytest.mark.cuda
def test_tensor_scalars_launch_the_kernels(cuda):
    # a 0-d tensor alpha or beta on the card is read with float(): the
    # kernel runs, never the oracle
    A, B, C = (rand((256, 256), s).to(cuda) for s in (26, 27, 28))
    a, b = (torch.tensor(v, device=cuda) for v in (0.5, -1.0))
    kernels.reset_launch_counts()
    got = (ct.sgemm("N", "T", a, A, B, b, C), ct.ssyrk("L", "N", a, A, b, C),
           ct.strmm("L", "U", "N", "U", a, A, B))
    counts = kernels.launch_counts()
    assert (counts["gemm_f32"], counts["syrk_lower_f32"],
            counts["trmm_lln_f32"]) == (1, 1, 1), counts
    want = (ct.sgemm("N", "T", 0.5, A, B, -1.0, C),
            ct.ssyrk("L", "N", 0.5, A, -1.0, C),
            ct.strmm("L", "U", "N", "U", 0.5, A, B))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("side,trans", [("L", "N"), ("R", "T")])
def test_trsm_tensor_alpha_launches_the_kernels(cuda, side, trans):
    # a 0-d tensor alpha on the card is read with float(): the kernels run
    A = torch.eye(8, device=cuda) * 2.0
    B = torch.ones((8, 3) if side == "L" else (3, 8), device=cuda)
    kernels.reset_launch_counts()
    X = ct.strsm(side, "L", trans, "N", torch.tensor(0.5, device=cuda), A, B)
    assert kernels.launch_counts()["gemm_f32"] > 0
    assert torch.equal(X, torch.full_like(B, 0.25))
    assert torch.equal(ct.trsm(side, "L", trans, "N", torch.tensor(0.5), A, B),
                       ct.trsm(side, "L", trans, "N", 0.5, A, B))


@pytest.mark.cuda
@pytest.mark.parametrize("side,uplo,trans,diag", [
    ("L", "L", "N", "N"), ("L", "U", "N", "N"), ("L", "L", "T", "U"),
    ("L", "U", "T", "N"), ("R", "L", "N", "N"), ("R", "U", "T", "U")])
def test_strmm_on_the_card(cuda, side, uplo, trans, diag):
    # one trmm_lln_f32 launch per call, no gemm_f32, any combination
    n, m = 1000, 300
    A = rand((n, n), 15) / 32.0 + torch.eye(n)
    B = rand((n, m) if side == "L" else (m, n), 16)
    kernels.reset_launch_counts()
    C = ct.strmm(side, uplo, trans, diag, 1.5, A.to(cuda), B.to(cuda))
    counts = kernels.launch_counts()
    assert counts["trmm_lln_f32"] == 1 and counts["gemm_f32"] == 0, counts
    ref = ct.trmm(side, uplo, trans, diag, 1.5, A.double(), B.double(),
                  backend="ref")
    assert_close(C, ref, 2 * n + 3, f"strmm {side}{uplo}{trans}{diag}")


@pytest.mark.cuda
def test_sgemm_ssyrk_dtrmm_on_the_card(cuda):
    A, B, C = (rand((300, 300), s).to(cuda) for s in (17, 18, 19))
    kernels.reset_launch_counts()
    G = ct.sgemm("T", "N", 0.5, A, B, -1.0, C)
    S = ct.ssyrk("U", "T", 1.0, A, 0.5, C)
    counts = kernels.launch_counts()
    assert counts["gemm_f32"] == 1 and counts["syrk_lower_f32"] == 1, counts
    Ad, Bd, Cd = (X.double() for X in (A, B, C))
    assert_close(G, 0.5 * Ad.T @ Bd - Cd, 2 * 300 + 3, "sgemm")
    assert_close(torch.triu(S), torch.triu(Ad.T @ Ad + 0.5 * Cd),
                 2 * 300 + 3, "ssyrk")
    assert torch.equal(torch.tril(S, -1), torch.tril(C, -1))
    # f64 on the card: the Ozaki kernels, never the f32 trmm
    L = torch.tril(rand((700, 700), 20).double()).to(cuda)
    X = rand((700, 90), 21).double().to(cuda)
    kernels.reset_launch_counts()
    D = ct.dtrmm("L", "L", "N", "N", 1.0, L, X)
    counts = kernels.launch_counts()
    assert counts["trmm_lln_f32"] == 0 and counts["peel_f64"] > 0 \
        and counts["mm_groups_f64"] > 0, counts
    ref = L @ X
    assert float((D - ref).abs().max()) <= 700 * 2.0 ** -40 * float(
        ref.abs().max())


@pytest.mark.cuda
def test_leaf_routes_on_the_card(cuda):
    # spotf2 above the whole-block kernels' cap, and strtri with a block
    # size above trtri_stream_f32's, each ONE leaf launch (at 8320, past
    # STREAM_MAX_N, so whatever the tuned caps)
    n = 8320
    A = latmc(torch.Generator(device=cuda).manual_seed(0), n, 30.0)
    kernels.reset_launch_counts()
    F, info = ct.spotf2("L", A)
    assert int(info) == 0 and kernels.launch_counts()["potf2_f32"] == 1
    Fd = torch.tril(F).double()
    err = float((Fd @ Fd.T - A.double()).abs().max())
    assert err <= n * 2 * EPS32 * float(A.abs().max()), err
    L = torch.tril(F)
    kernels.reset_launch_counts()
    W, info = ct.strtri("L", "N", L, block_size=n)
    assert int(info) == 0 and kernels.launch_counts()["trti2_f32"] == 1
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    ref = torch.linalg.solve_triangular(L.double(), eye, upper=False)
    assert_close(torch.tril(W), ref, 60 * n, "strtri block_size=n")


@pytest.mark.cuda
def test_lauum_block_2048_on_the_card(cuda):
    # leaves above 1024 go to lauu2_f32 (it used to raise there)
    n = 4096
    A = latmc(torch.Generator(device=cuda).manual_seed(1), n, 30.0)
    L = torch.tril(torch.linalg.cholesky(A))
    kernels.reset_launch_counts()
    R = ct.lauum("L", L, block_size=2048)
    assert kernels.launch_counts()["lauu2_f32"] == 2
    assert_close(torch.tril(R), mega.lauum_stream_plain(L), 2 * n + 3,
                 "lauum block_size=2048")


# ---------------------------------------------------------------------------
# the device fills and the c/z tier
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1, 1), (100, 57), (257, 3),
                                       (1000, 4096)])
def test_fills_vs_twins(cuda, rows, cols):
    seeds = rdev._mix_seeds(9, -(-rows // prng.rows_per_block(rows)))
    kernels.reset_launch_counts()
    for fill, plain in ((prng.uniform_fill_f32, prng.uniform_fill_f32_plain),
                        (prng.uniform_fill_f64, prng.uniform_fill_f64_plain)):
        got = fill(seeds.to(cuda), rows, cols)
        assert torch.equal(got, plain(seeds.to(cuda), rows, cols))
        assert torch.equal(got.cpu(), plain(seeds, rows, cols))
    counts = kernels.launch_counts()
    assert counts["uniform_fill_f32"] == counts["uniform_fill_f64"] == 1


@pytest.mark.cuda
def test_uniform_device_defaults_to_the_card(cuda):
    u = uniform_device(3, (300, 70), "(0,1)")
    v = uniform_device64(3, (300, 70), "[0,1]")
    assert u.device.type == v.device.type == "cuda"
    assert torch.equal(u.cpu(), uniform_device(3, (300, 70), "(0,1)",
                                               device="cpu"))
    assert torch.equal(v.cpu(), uniform_device64(3, (300, 70), "[0,1]",
                                                 device="cpu"))


def crand(n, m, dtype, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal((n, m))
                            + 1j * g.standard_normal((n, m))).to(dtype)


@pytest.mark.cuda
def test_complex_auto_embeds_on_the_card(cuda):
    # a c64 CUDA tensor goes through the embedding onto the f32 kernels
    # (cpotrf at 1024 is one potrf_stream_f32 launch at 2048), never the
    # torch tile
    n = 1024
    re, im = latmc_pair(torch.Generator().manual_seed(2), n, 30.0,
                        torch.float64)
    A = torch.complex(re, im)
    kernels.reset_launch_counts()
    F, info = ct.cpotrf("L", A.to(torch.complex64).to(cuda))
    counts = kernels.launch_counts()
    assert int(info) == 0 and counts["potrf_stream_f32"] == 1, counts
    assert sum(counts.values()) == 1, counts
    L = torch.tril(F).cpu().to(torch.complex128)
    err = float((L @ L.mH - A).abs().max())
    assert err <= 2 * n * 2 * EPS32 * float(A.abs().max()), err
    # a c128 pair goes to the d tier: the Ozaki kernels and the f32 leaves
    kernels.reset_launch_counts()
    (fr, fi), info = ct.zpotrf("L", (re.to(cuda), im.to(cuda)))
    counts = kernels.launch_counts()
    assert int(info) == 0 and all(counts[k] > 0 for k in D_PATH), counts
    assert counts["gemm_f32"] == counts["potrf_stream_f32"] == 0, counts
    L = torch.tril(torch.complex(fr, fi)).cpu()
    err = float((L @ L.mH - A).abs().max())
    assert err <= 2 * n * 2.0 ** -40 * float(A.abs().max()), err


@pytest.mark.cuda
def test_complex_blas_on_the_card(cuda):
    n = 300
    A, B, C = (crand(n, n, torch.complex64, s) for s in (1, 2, 3))
    Ad, Bd, Cd = (X.to(torch.complex128) for X in (A, B, C))
    kernels.reset_launch_counts()
    G = ct.cgemm("N", "C", 0.5 + 1j, A.to(cuda), B.to(cuda), -1.0,
                 C.to(cuda))
    H = ct.cherk("L", "N", 2.0, A.to(cuda), 0.5, C.to(cuda))
    T = ct.ctrmm("L", "U", "C", "N", 1j, A.to(cuda), B.to(cuda))
    counts = kernels.launch_counts()
    assert counts["gemm_f32"] >= 3 and counts["trmm_lln_f32"] == 0, counts
    assert_close(G.cpu(), (0.5 + 1j) * Ad @ Bd.mH - Cd, 2 * 2 * n + 3,
                 "cgemm")
    want = torch.tril(2.0 * Ad @ Ad.mH + 0.5 * Cd) + torch.triu(Cd, 1)
    want.diagonal().imag.zero_()
    assert_close(H.cpu(), want, 2 * 2 * n + 3, "cherk")
    assert bool((H.diagonal().imag == 0).all())
    assert_close(T.cpu(), 1j * torch.triu(Ad).mH @ Bd, 2 * 2 * n + 3,
                 "ctrmm")
    # trsm with fill-made pair right-hand sides, c and z
    L = torch.tril(A) + 20.0 * torch.eye(n)
    for fill, dtype in ((uniform_device, torch.float32),
                        (uniform_device64, torch.float64)):
        Bp = (fill(5, (n, 64)), fill(6, (n, 64)))
        Lp = (L.real.to(dtype).to(cuda), L.imag.to(dtype).to(cuda))
        X = ct.trsm("L", "L", "C", "N", 1.0, Lp, Bp)
        Xc = torch.complex(*X).cpu().to(torch.complex128)
        Bc = torch.complex(*Bp).cpu().to(torch.complex128)
        Lc = L.to(torch.complex128)
        res = float((Lc.mH @ Xc - Bc).abs().max())
        assert res <= 150 * n * (EPS32 if dtype == torch.float32
                                 else 2.0 ** -40), res


# --- the block-cyclic tier (cholesky_tpu_torch.parallel) on one NCCL rank ---

DIST_NB = 256


@pytest.fixture(scope="module")
def nccl():
    """This process's default group as a one-rank NCCL world for the
    module's dist tests, destroyed after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    import torch.distributed as dist
    from cholesky_tpu_torch.parallel import launch
    launch.init_single("cuda")
    yield torch.device("cuda")
    dist.destroy_process_group()


def dist_counts(fn):
    """fn() with the launch and collective counters at 0 before it: (its
    result, the launches, the collectives)."""
    from cholesky_tpu_torch.parallel import comm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    comm.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts(), comm.counts()


def diag_launches(n):
    """potrf_dist at nb = 256 on one rank factors and inverts each of the
    n/256 diagonal blocks once (the block-0 prologue and one lookahead per
    step but the last)."""
    nblk = -(-n // DIST_NB)
    return {"potrf_block_f32": nblk, "trtri_block_f32": nblk,
            "potrf_stream_f32": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 2048])
def test_dist_potrf_logdet_on_the_card(nccl, n):
    from cholesky_tpu_torch import parallel as par
    A = spd(n, seed=n).to(nccl)
    (F, info), launches, coll = dist_counts(
        lambda: par.potrf_sharded("L", A, nb=DIST_NB))
    nblk = n // DIST_NB
    assert int(info) == 0
    assert {k: launches[k] for k in diag_launches(n)} == diag_launches(n)
    assert launches["gemm_f32"] == 3 * (nblk - 1)     # panel, fold, update
    assert coll == {"broadcast": nblk, "all_reduce": 0,
                    "all_gather": nblk}                # and the collect
    Fr, _ = ct.potrf("L", A)
    assert_close(torch.tril(F), torch.tril(Fr), 8 * n, "potrf_sharded")
    (ld, info), launches, _ = dist_counts(
        lambda: par.logdet_dist(par.distribute(A, nb=DIST_NB)))
    ref, _ = ct.logdet("L", A)
    assert int(info) == 0 and launches["potrf_block_f32"] == nblk
    assert abs(float(ld) - float(ref)) <= n * EPS32 * abs(float(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("trans", ["N", "T"])
def test_dist_trsm_on_the_card(nccl, trans):
    from cholesky_tpu_torch import parallel as par
    n = 2048
    A = spd(n, seed=7).to(nccl)
    B = rand((n, 16), 8).to(nccl)
    fbc, info = par.potrf_dist(par.distribute(A, nb=DIST_NB))
    X, launches, coll = dist_counts(
        lambda: par.trsm_factor_dist(fbc, B, trans))
    assert int(info) == 0 and not any(launches.values())
    nblk = n // DIST_NB
    assert coll["broadcast"] == (nblk if trans == "N" else 2 * nblk - 1)
    # against an f64 solve of the same factor, within F32_GATE times f32
    # solve_triangular's error, that limit below 1 % of the solution's RMS
    L = torch.tril(par.collect(fbc))
    up = trans == "T"
    op = L.T if up else L
    ref = torch.linalg.solve_triangular(op.double(), B.double(), upper=up)
    yard = torch.linalg.solve_triangular(op, B, upper=up)
    gated(f"trsm_factor_dist {trans}", X, ref, yard,
          rms=float(ref.square().mean().sqrt()))


@pytest.mark.cuda
def test_dist_potri_on_the_card(nccl):
    from cholesky_tpu_torch import parallel as par
    n = 2048
    F = dense_factor(n, seed=9)
    (Inv, info), launches, coll = dist_counts(
        lambda: par.potri_sharded("L", F, nb=DIST_NB))
    nblk = n // DIST_NB
    assert int(info) == 0
    assert launches["trtri_block_f32"] == nblk and launches["gemm_f32"] > 0
    assert coll["all_reduce"] == (nblk - 1) * (nblk - 2) // 2 + 1
    # against the f64 inverse of the same factor, within F32_GATE times f32
    # cholesky_inverse's error, that limit below 1 % of the strict lower's
    # RMS; ct.potri's info beside it
    _, info_ref = ct.potri("L", F)
    assert int(info_ref) == 0
    ref64 = torch.tril(torch.cholesky_inverse(F.double()))
    gated("potri_sharded", torch.tril(Inv), ref64,
          torch.tril(torch.cholesky_inverse(F)))


@pytest.mark.cuda
def test_dist_f64_on_the_ozaki_kernels(nccl):
    from cholesky_tpu_torch import parallel as par
    n = 1024
    A = spd(n, seed=10).double().to(nccl)
    (F, info), launches, _ = dist_counts(
        lambda: par.potrf_sharded("L", A, nb=DIST_NB))
    assert int(info) == 0
    assert launches["peel_f64"] > 0 and launches["mm_groups_f64"] > 0
    assert launches["potrf_block_f32"] == n // DIST_NB
    L = torch.tril(F)
    err = float((L @ L.T - A).abs().max()) / float(A.abs().max())
    assert err <= n * 2.0 ** -40, err


@pytest.mark.cuda
def test_dist_nonpd_info_as_potrf_on_the_card(nccl):
    from cholesky_tpu_torch import parallel as par
    A = spd(1024, seed=11).to(nccl)
    A[700, 700] = -1.0
    F, info = par.potrf_sharded("L", A, nb=DIST_NB)
    _, info_ref = ct.potrf("L", A)
    assert int(info) == int(info_ref) == 701
    assert bool(torch.isfinite(F[:700, :700]).all())


@pytest.mark.cuda
def test_dist_cuda_tensor_on_a_gloo_group_raises(nccl):
    import torch.distributed as dist
    from cholesky_tpu_torch import parallel as par
    gloo = dist.new_group(backend="gloo")
    A = spd(512, seed=12).to(nccl)
    with pytest.raises(ValueError, match="needs a nccl group"):
        par.potrf_sharded("L", A, group=gloo, nb=DIST_NB)


def dense_blas_operands(n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(n, n, device="cuda", dtype=dtype, generator=g)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype,kernels_used", [
    ("gemm", torch.float32, ()),
    ("syrk", torch.float32, ()),
    ("trsm", torch.float32, ("trtri_block_f32", "gemm_f32")),
    ("trmm", torch.float32, ("trmm_lln_f32",)),
    ("herk", torch.complex64, ()),
    ("gemm", torch.float64, ("peel_f64", "mm_groups_f64")),
    ("trsm", torch.float64, ("peel_f64", "mm_groups_f64", "trtri_block_f32")),
    ("trmm", torch.float64, ("peel_f64", "mm_groups_f64")),
], ids=lambda v: str(v).replace("torch.", ""))
def test_dist_blas_on_the_card(nccl, op, dtype, kernels_used):
    # one call of each distributed BLAS routine on a one-rank NCCL group:
    # one all_gather, the kernels of its stripe, and f32/c64 held against
    # the f64/c128 result within F32_GATE times the library call's error
    # (f64 within n·2^-40 of max|ref|, the d tier's rule)
    from cholesky_tpu_torch import parallel as par
    n = 2048 if dtype != torch.float64 else 1024
    A, B, C = dense_blas_operands(n, dtype, seed=20)
    if op == "trsm":
        A = torch.linalg.cholesky(
            (A @ A.mT / n + torch.eye(n, device=nccl, dtype=dtype)
             ).double()).to(dtype)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    A64, B64, C64 = (x.to(wide) for x in (A, B, C))
    call, ref, lib = {
        "gemm": (lambda: par.gemm_dist("N", "T", 0.5, A, B, 2.0, C),
                 0.5 * A64 @ B64.T + 2.0 * C64,
                 lambda: torch.addmm(C, A, B.T, beta=2.0, alpha=0.5)),
        "syrk": (lambda: par.syrk_dist("L", "T", -1.0, A, 1.0, C),
                 torch.tril(C64 - A64.T @ A64) + torch.triu(C64, 1),
                 lambda: torch.tril(C - A.T @ A) + torch.triu(C, 1)),
        "herk": (lambda: par.herk_dist("U", "N", 1.0, A, 0.5, C),
                 torch.triu(A64 @ A64.mH + 0.5 * C64) + torch.tril(C64, -1),
                 lambda: torch.triu(A @ A.mH + 0.5 * C) + torch.tril(C, -1)),
        "trsm": (lambda: par.trsm_dist("R", "L", "T", "N", 1.0, A, B),
                 torch.linalg.solve_triangular(A64.T, B64, upper=True,
                                               left=False),
                 lambda: torch.linalg.solve_triangular(A.T, B, upper=True,
                                                       left=False)),
        "trmm": (lambda: par.trmm_dist("L", "U", "N", "N", 1.0, A, B),
                 torch.triu(A64) @ B64, lambda: torch.triu(A) @ B),
    }[op]
    yard = lib()
    if op == "herk":
        ref.diagonal().imag.zero_()
        yard.diagonal().imag.zero_()
    out, launches, coll = dist_counts(call)
    assert coll == {"broadcast": 0, "all_reduce": 0, "all_gather": 1}
    assert all(launches[k] > 0 for k in kernels_used), launches
    assert not any(v for k, v in launches.items() if k not in kernels_used)
    if dtype == torch.float64:
        rel = float((out - ref).abs().max()) / float(ref.abs().max())
        assert rel <= n * 2.0 ** -40, rel
    else:
        gated(f"{op}_dist {dtype}", out, ref, yard,
              rms=float(ref.abs().square().mean().sqrt()))


def hutchinson64(params, X, y, Z):
    """The distributed GP step's mean (nll, three gradients) over the
    batch, in f64 on torch.linalg with the same probes."""
    amp, ell2, noise = (torch.exp(2.0 * v.double()) for v in params)
    out = 0.0
    for Xb, yb, Zb in zip(X.double(), y.double(), Z.double()):
        n = Xb.shape[0]
        D = torch.cdist(Xb, Xb).square()
        Kf = amp * torch.exp(-0.5 * D / ell2)
        L = torch.linalg.cholesky(Kf + (noise + 1e-6) * torch.eye(
            n, dtype=Kf.dtype, device=Kf.device))
        sol = torch.cholesky_solve(torch.cat([yb[:, None], Zb], 1), L)
        a, U = sol[:, 0], sol[:, 1:]

        def grad(dK):
            return 0.5 * ((U * (dK @ Zb)).sum(0).mean() - a @ (dK @ a))

        out = out + torch.stack([
            0.5 * (yb @ a + 2.0 * torch.log(L.diagonal()).sum()
                   + n * np.log(2.0 * np.pi)),
            grad(2.0 * Kf), grad(Kf * D / ell2),
            (0.5 * ((U * Zb).sum(0).mean() - a @ a)) * 2.0 * noise])
    return out / X.shape[0]


@pytest.mark.cuda
def test_dist_gp_step_on_the_card(nccl):
    # make_gp_train_step on a (1, 1) mesh of the one-rank NCCL group at
    # n_train 2048, batch 2, nb 256: the diagonal kernels once per block
    # per problem, the step's collectives, and (nll, gradients) against
    # the f64 Hutchinson estimator on the same probes; lr = 1 gives the
    # gradients back as params − params'
    from cholesky_tpu_torch.models import make_gp_train_step
    from cholesky_tpu_torch.parallel import launch
    n, d, batch = 2048, 8, 2
    g = torch.Generator(device="cuda").manual_seed(21)
    X = torch.randn(batch, n, d, device="cuda", generator=g)
    y = torch.sin(X[..., 0]) + 0.1 * torch.randn(batch, n, device="cuda",
                                                 generator=g)
    Z = torch.randint(0, 2, (batch, n, 2), device="cuda",
                      generator=g).float() * 2.0 - 1.0
    step = make_gp_train_step(launch.mesh2d(1, 1), n, d, batch, nb=DIST_NB,
                              lr=1.0)
    p0 = gp.GPParams.init()
    (p1, nll, infos), launches, coll = dist_counts(
        lambda: step(p0, X, y, Z))
    nblk = n // DIST_NB
    assert infos.tolist() == [0] * batch
    assert launches["potrf_block_f32"] == launches["trtri_block_f32"] \
        == batch * nblk
    assert launches["gemm_f32"] > 0 and launches["potrf_stream_f32"] == 0
    assert coll == {"broadcast": batch * (4 * nblk - 1),
                    "all_reduce": batch * nblk + 1,
                    "all_gather": batch * (nblk - 1) + 1}
    got = torch.stack([nll.double()] + [a.double() - b.double()
                                        for a, b in zip(p0, p1)])
    ref = hutchinson64(p0, X, y, Z)
    assert torch.allclose(got, ref, rtol=1e-3, atol=0.0), (got, ref)


# ---------------------------------------------------------------------------
# the tooling: profiling, the task pool, the sweep and minibench
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_trace_names_a_kernel(cuda, tmp_path):
    # a trace of one gemm_f32 launch inside a span names the kernel and
    # the span, and device_time counts the launch. The window is a fresh
    # process's: the card's profiler loses the first records of a window
    # in a process that has run many launches, and profiling.trace has no
    # guards, so the tests that ran before this one must not decide it
    import json as _json
    import subprocess
    import sys
    from pathlib import Path

    child = f"""
import json
import torch
from cholesky_tpu_torch.ops.kernels import gemm
from cholesky_tpu_torch.utils import profiling
A = torch.randn((1024, 1024), generator=torch.Generator().manual_seed(31))
A = A.to("cuda")
gemm.gemm_f32(A, A)
with profiling.trace({str(tmp_path)!r}):
    with profiling.annotate("sweep-gemm"):
        gemm.gemm_f32(A, A)
census = profiling.device_time(lambda: gemm.gemm_f32(A, A), "gemm")
print(json.dumps(census["busy"]))
"""
    # 20 s on the card with the kernels built; run alone, the child makes
    # the first nvcc build of every kernel too (20-70 s)
    done = subprocess.run([sys.executable, "-c", child],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-4000:]
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e.get("name", "") for e in
             _json.loads(path.read_text())["traceEvents"]]
    assert "sweep-gemm" in names
    assert any("gemm64_kernel" in x or "gemm128_kernel" in x for x in names)
    busy_ms, launches = _json.loads(done.stdout.strip().splitlines()[-1])
    assert launches == 1 and busy_ms > 0.0


@pytest.mark.cuda
def test_kernel_events_returns_the_kernel_or_raises(cuda):
    # a window with one gemm_f32 launch gives its kernel, or raises when
    # the profiler lost it: never a census without the launched kernel
    from cholesky_tpu_torch.utils import profiling
    A = rand((1024, 1024), 31).to(cuda)
    gemm.gemm_f32(A, A)
    for _ in range(10):
        try:
            _, events = profiling.kernel_events(lambda: gemm.gemm_f32(A, A))
        except profiling.LostKernels:
            continue
        assert [kname for kname, _, _ in events
                if "gemm" in kname] != [], events


@pytest.mark.cuda
def test_span_events_bracket_the_launch(cuda):
    # under collect(device=True) a kernel span's event pair brackets its
    # launch: potrf_stream_f32 at 1024 reads its CUDA-event time alone
    # within 10 %, medians of five launches each, each queued behind a
    # spin of about a millisecond so that neither reading holds the host's
    # launch path
    from cholesky_tpu_torch.utils import profiling
    A = spd(1024, seed=34).to(cuda)
    mega.potrf_stream_f32(A.clone())
    torch.cuda.synchronize()
    alone = []
    for _ in range(5):
        X = A.clone()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mega.potrf_stream_f32(X)
        end.record()
        end.synchronize()
        alone.append(start.elapsed_time(end))
    with profiling.collect(device=True) as spans:
        for _ in range(5):
            X = A.clone()
            torch.cuda._sleep(2_000_000)
            mega.potrf_stream_f32(X)
            torch.cuda.synchronize()
    got = [s.device_ms() for s in spans]
    assert [s.name for s in spans] == ["kernel.potrf_stream_f32"] * 5
    assert all(s.attrs == {"n": 1024, "dtype": "float32"} for s in spans)
    a, b = sorted(alone)[2], sorted(got)[2]
    assert abs(b - a) <= 0.1 * a, (alone, got)


@pytest.mark.cuda
def test_task_pool_worker_launches_a_kernel(cuda):
    # a native worker thread of the pool launches gemm_f32 on the card
    from cholesky_tpu_torch.runtime import TaskPool
    A = rand((512, 384), 32).to(cuda)
    B = rand((384, 256), 33).to(cuda)
    got = {}

    def task():
        got["C"] = gemm.gemm_f32(A, B)
        torch.cuda.synchronize()
        return 0

    with TaskPool(2) as pool:
        assert pool.run(1, task).join() == 0
    assert_close(got["C"], A.double() @ B.double(), 2 * 384 + 3,
                 "gemm_f32 from a pool worker")


@pytest.mark.cuda
def test_sweep_row_passes_at_1024(cuda, tmp_path):
    # one sweep point on the card: passed, scored, the card named
    from cholesky_tpu_torch.tools import sweep
    from cholesky_tpu_torch.utils.benchlib import card
    out = tmp_path / "rows.jsonl"
    kernels.reset_launch_counts()
    assert sweep.main(["--ops", "potrf", "--sizes", "1024", "--out",
                       str(out), "--max-chain", "3"]) == 0
    (row,) = sweep.load_rows(out)
    assert row["passed"] and row["info"] == 0 and row["card"] == card()
    assert row["max_err"] <= row["tol"] and row["gflops"] > 0
    assert kernels.launch_counts()["potrf_stream_f32"] >= 5


@pytest.mark.cuda
def test_minibench_timer_probe(cuda):
    # synchronize() waits for the card: the host clock around a call and
    # a synchronize covers the call's CUDA-event time
    from cholesky_tpu_torch.tools import minibench
    t = minibench.probe_timer()
    assert t["block_is_trustworthy"], t
    assert t["synchronize_ms"] >= 0.5 * t["event_ms"] > 0.0


# ---------------------------------------------------------------------------
# the d tier's one-launch peel and product against the passes they replace
# ---------------------------------------------------------------------------

def edge_rows(m, k, seed):
    """An f64 (m, k) matrix of wide-range rows and, in its first rows, the
    scaling's edges: a zero row, f32-subnormal and f64-subnormal rows, a
    max that rounds up to the next power of two in f32, the f32 overflow
    edge on both sides, NaN, +inf and -inf."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(m, k, generator=g, dtype=torch.float64) * torch.exp(
        2.0 * torch.randn(m, k, generator=g, dtype=torch.float64))
    f32max = float(np.finfo(np.float32).max)
    A[0] = 0.0
    A[1] *= 1e-41                              # f32 subnormal maxima
    A[2] *= 1e-310                             # f64 subnormals: f32 zero
    A[3] = torch.linspace(-1.0, 1.0, k, dtype=torch.float64)
    A[3, k // 2] = 2.0 - 2.0 ** -30            # f32(max) = 2.0
    A[4] = A[3] * f32max / 2.0
    A[4, k // 3] = f32max                      # max at the f32 edge
    A[5] = A[4]
    A[5, k // 3] = 3.5e38                      # f32(max) = inf
    A[6, k // 4] = float("nan")
    A[7, k // 5] = float("inf")
    A[8, k - 1] = float("-inf")
    return A


def padded_slices(X):
    """The (S, m, kp) buffer a peel is a view of, padding included."""
    S, m, _ = X.shape
    return X.as_strided((S, m, X.stride(1)), X.stride())


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["rows", "transposed", "k offset 16",
                                  "k offset 3", "transposed, k offset 3",
                                  "edges", "edges transposed"])
@pytest.mark.parametrize("slices", [1, 6, 8])
def test_peel_f64_vs_scaled_pair_and_peel(cuda, slices, view):
    # the one-launch peel against the passes it replaces on the card,
    # slices (padding included) and row scales bit for bit, on both
    # kernels (rows along and across the unit stride)
    m, k = 70, 300
    if view.startswith("edges"):
        A = edge_rows(m, k, 31).to(cuda)
    else:
        A = edge_rows(m + 9, k + 40, 32)[9:].to(cuda)
    if view == "transposed":                   # as matmul_f64 peels B.T
        A = A[:, :k].T.contiguous().T
    elif view == "k offset 16":
        A = A[:, 16:16 + k]
    elif view == "k offset 3":
        A = A[:, 3:3 + k]
    elif view == "transposed, k offset 3":
        A = A.T.contiguous()[3:3 + k].T        # a sub-block of Bᵀ
    elif view == "edges transposed":
        A = A.T.contiguous().T
    else:
        A = A[:, :k].contiguous()
    assert (A.stride(0) == 1) == ("transposed" in view)
    kernels.reset_launch_counts()
    got, gsc = ozk.peel_f64(A, slices=slices)
    assert kernels.launch_counts()["peel_f64"] == 1
    rh, rl, wsc = ozk.scaled_pair(A)
    want = ozk.peel_f32pair(rh, rl, slices=slices)
    assert got.shape == want.shape == (slices, m, A.shape[1])
    assert torch.equal(padded_slices(got), padded_slices(want))
    assert torch.equal(gsc, wsc)
    assert torch.equal(ozaki.split_rows(A, slices)[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,view", [(1, 8192, "rows"), (1, 4096, "B[:n1].T"),
                                      (16, 4096, "B[:n1].T"),
                                      (128, 8192, "B[:n1].T"),
                                      (40, 3001, "edges"),
                                      (40, 3001, "edges transposed"),
                                      (500, 700, "transposed")])
def test_peel_f64_of_few_rows_splits_k(cuda, m, k, view):
    # views whose rows cannot fill the card (a solve's B[:n1].T with nrhs
    # rows) split k among blocks in one launch: slices (padding included)
    # and row scales bit for bit the passes, NaN, inf and zero rows too
    if view.startswith("edges"):
        A = edge_rows(m, k, 33)
    else:
        A = torch.randn(m, k, generator=torch.Generator().manual_seed(m + k),
                        dtype=torch.float64)
    if view == "B[:n1].T":                     # B (n, nrhs) row-major
        A = torch.cat([A.T, A.T[:7]]).to(cuda)[:k].T
    elif view.endswith("transposed"):
        A = A.T.contiguous().to(cuda).T
    else:
        A = A.to(cuda)
    assert A.stride(0) == 1 or A.stride(1) == 1
    kernels.reset_launch_counts()
    got, gsc = ozk.peel_f64(A, slices=6)
    assert kernels.launch_counts()["peel_f64"] == 1
    rh, rl, wsc = ozk.scaled_pair(A)
    want = ozk.peel_f32pair(rh, rl, slices=6)
    assert torch.equal(padded_slices(got), padded_slices(want))
    assert torch.equal(gsc, wsc)


def composed(As, asc, Bs, bsc, out, alpha, beta):
    """The torch passes mm_groups_f64 replaces, as the d tier composed
    them: the pair of mm_groups_f32pair (summed in f64 chunk by chunk past
    K_EXACT_MAX), rescaled, then the caller's update."""
    k = As.shape[2]
    if k > ozaki.K_EXACT_MAX:
        P = torch.zeros((As.shape[1], Bs.shape[1]), dtype=torch.float64,
                        device=As.device)
        for c in range(0, k, ozaki._K_CHUNK):
            hi, lo = kernels.mm_groups_f32pair(As[:, :, c:c + ozaki._K_CHUNK],
                                               Bs[:, :, c:c + ozaki._K_CHUNK])
            P += (hi.double() + lo.double()) * asc[:, None] * bsc[None, :]
    else:
        hi, lo = kernels.mm_groups_f32pair(As, Bs)
        P = (hi.double() + lo.double()) * asc[:, None] * bsc[None, :]
    ref = out.clone()
    if (alpha, beta) == (-1.0, 1.0):
        ref -= P                               # the trsm updates
    elif (alpha, beta) == (1.0, 1.0):
        ref += P                               # trmm's
    elif (alpha, beta) == (1.0, 0.0):
        ref.copy_(P)                           # trmm's leaf
    else:
        D = alpha * P                          # syrk_ln's and mm's
        ref = D + beta * ref if beta != 0.0 else D
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.0, 1.0), (1.0, 1.0),
                                        (-1.0, 0.0), (0.5, 2.0)])
@pytest.mark.parametrize("m,n,k,layout", [(200, 130, 300, "rows"),
                                          (1100, 700, 500, "rows"),
                                          (130, 200, 300, "columns"),
                                          (16, 24, 40000, "rows"),
                                          (16, 24, 64000, "columns")])
def test_mm_groups_f64_vs_the_composed_passes(cuda, alpha, beta, m, n, k,
                                              layout):
    # the product's f64 epilogue in place in a strided view of a wider
    # matrix, bit for bit the passes it replaces: both tile widths, k past
    # the kernel's int32 chunk (40000) and past K_EXACT_MAX (64000)
    g = torch.Generator().manual_seed(m + n + k)
    A = torch.randn(m, k, generator=g, dtype=torch.float64) * torch.exp(
        2.0 * torch.randn(m, k, generator=g, dtype=torch.float64))
    B = torch.randn(n, k, generator=g, dtype=torch.float64)
    As, asc = ozaki.split_rows(A.to(cuda), 6)
    Bs, bsc = ozaki.split_rows(B.to(cuda), 6)
    big = torch.randn(m + n + 9, m + n + 7, generator=g,
                      dtype=torch.float64).to(cuda)
    out = big[3:3 + m, 4:4 + n] if layout == "rows" else \
        big[5:5 + n, 2:2 + m].T
    ref = composed(As, asc, Bs, bsc, out, alpha, beta)
    before = big.clone()
    kernels.reset_launch_counts()
    got = ozaki.matmul_presplit(As, asc, Bs, bsc, out=out, alpha=alpha,
                                beta=beta)
    chunks = -(-k // ozaki._K_CHUNK) if k > ozaki.K_EXACT_MAX else 1
    assert kernels.launch_counts()["mm_groups_f64"] == chunks
    assert got is out and torch.equal(out, ref)
    out.copy_(before[3:3 + m, 4:4 + n] if layout == "rows" else
              before[5:5 + n, 2:2 + m].T)
    assert torch.equal(big, before)            # nothing outside the view


@pytest.mark.cuda
def test_dtier_peels_and_products_are_one_launch_each(cuda):
    # dpotrf + dpotri at 1024: one launch of peel_f64 for every
    # ozaki.split span and one of mm_groups_f64 for every ozaki.product
    # span, and no torch op inside either span launches a device kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    A = (spd(1024).double()).to(cuda)
    A = 0.5 * (A + A.T)
    ct.dpotri("L", ct.dpotrf("L", A)[0])       # build and warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        F, i1 = ct.dpotrf("L", A)
        inv, i2 = ct.dpotri("L", F)
        torch.cuda.synchronize()
    assert int(i1) == int(i2) == 0
    counts = kernels.launch_counts()
    assert counts["peel_f32pair"] == counts["mm_groups_f32pair"] == 0
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = {"ozaki.split": [], "ozaki.product": []}
    for e in events:
        if e.name in spans:
            spans[e.name].append(e)
    assert counts["peel_f64"] == len(spans["ozaki.split"]) > 0
    assert counts["mm_groups_f64"] == len(spans["ozaki.product"]) > 0

    def inside(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name in spans:
                return True
        return False

    # allocation and views are host work; any other torch op would be a
    # pass over device memory
    host_only = {"aten::empty", "aten::empty_strided", "aten::slice",
                 "aten::as_strided", "aten::view", "aten::t",
                 "aten::transpose", "aten::select", "aten::alias"}
    passes = collections.Counter(
        e.name for e in events if e.name.startswith("aten::")
        and e.name not in host_only and inside(e))
    assert not passes, passes
    launched = [e for e in events if "Launch" in e.name and inside(e)]
    assert len(launched) == counts["peel_f64"] + counts["mm_groups_f64"]
