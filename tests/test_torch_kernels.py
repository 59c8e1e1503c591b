"""The five kernels of the port's f32 potrf path (cholesky_tpu_torch/ops/
kernels/). On the CPU each wrapper runs its plain torch twin, which is held
here against the Pallas kernel it replaces, run in interpret mode as the
JAX package's own tests run it (tests/test_mega.py, test_pallas_kernels.py).
The CUDA kernels themselves are held against their twins on the card by
tests/test_torch_cuda.py.

Tolerances are the repo's eps-scaled bounds (tests/util.py): 2k+3 for a
product of depth k, 8n for a Cholesky factor, 60n for a triangular
inverse, as the JAX package's tests use."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_tpu.ops.pallas import gemm as pgemm
from cholesky_tpu.ops.pallas import mega as pmega
from cholesky_tpu.ops.pallas import syrk as psyrk
from cholesky_tpu_torch.ops.kernels import (gemm_f32, potrf_block_f32,
                                            potrf_stream_f32, syrk_lower_f32,
                                            trtri_block_f32)
from cholesky_tpu_torch.ops import lapack_ref
from cholesky_tpu_torch.ops.kernels import gemm as kgemm
from cholesky_tpu_torch.ops.kernels import leaf
from cholesky_tpu_torch.ops.kernels.leaf import lauu2_plain
from cholesky_tpu_torch.ops.kernels import mega
from cholesky_tpu_torch.ops.kernels import syrk as ksyrk
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


#: gemm_f32's launch rule: (m, n, A strides, A address, B strides, B
#: address) -> (tile, A k-fast, Bᵀ k-fast, 16-byte staging)
LAUNCH_CASES = {
    # potri's trtri recursion at 8192: 4096² views of one row-major buffer
    "views_of_one_buffer": ((4096, 4096, (8192, 1), 4096 * 4, (8192, 1),
                             8192 * 4096 * 4), (128, True, False, True)),
    # the panel solve's X·Tᵀ: Tᵀ a transposed view, so Bᵀ = T is k-fast
    "transposed_B": ((2048, 2048, (2048, 1), 0, (1, 2048), 0),
                     (128, True, True, True)),
    "transposed_A": ((2048, 2048, (1, 2048), 0, (2048, 1), 0),
                     (128, False, False, True)),
    "base_one_column_off": ((2048, 2048, (2048, 1), 4, (2048, 1), 0),
                            (128, True, False, False)),
    "odd_leading_stride": ((2048, 2048, (2049, 1), 0, (2048, 1), 0),
                           (128, True, False, False)),
    "no_unit_stride": ((2048, 2048, (4096, 2), 0, (2048, 1), 0),
                       (128, True, False, False)),
    "small_grid": ((1000, 777, (516, 1), 0, (780, 1), 0),
                   (64, True, False, True)),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_gemm_launch_plan(case):
    args, want = LAUNCH_CASES[case]
    assert kgemm.launch_plan(*args) == want


@pytest.mark.parametrize("extra,tile", [(-1, 64), (0, 128)])
def test_gemm_launch_plan_tile_threshold(extra, tile):
    # the 128 tile from GEMM128_MIN_TILES output tiles of 128 on
    tiles = kgemm.GEMM128_MIN_TILES + extra
    plan = kgemm.launch_plan(128 * tiles, 100, (512, 1), 0, (128, 1), 0)
    assert plan == (tile, True, False, True)


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


def test_syrk_row_fast_view_vs_pallas():
    # lauum's B11 += MᴴM: A = M.mH is a transposed view, row-fast
    M, C = rand((96, 200), 7), rand((200, 200), 8)
    A = torch.from_numpy(M.copy()).mH
    assert A.stride() == (1, 200)
    Ct = torch.from_numpy(C.copy())
    syrk_lower_f32(1.0, A, 1.0, Ct)
    ref = np.asarray(jax.jit(functools.partial(
        psyrk.syrk_f32, alpha=1.0, beta=1.0))(jnp.asarray(M.T.copy()),
                                             jnp.asarray(C)))
    got = Ct.numpy()
    assert_close(np.tril(got), np.tril(ref), F32, 2 * 96 + 3,
                 "syrk row-fast view")
    iu = np.triu_indices(200, 1)
    np.testing.assert_array_equal(got[iu], C[iu])


@pytest.mark.parametrize("n,k,strides,ptr,cut,want", [
    # the potrf recursion's shapes at 4096 with 512 leaves: runs for one
    # wave of 264 blocks, cutting tiles
    (512, 512, (4096, 1), 0, {}, (2, 160, True, True)),
    (1024, 1024, (4096, 1), 0, {}, (9, 256, True, True)),
    (2048, 2048, (4096, 1), 0, {}, (66, 264, True, True)),
    # runs of whole tiles: two a block at 4096 x 512, one a block from
    # WHOLE_MIN_TILES tiles (the public ssyrk at 8192)
    (4096, 512, (512, 1), 0, {}, (64, 264, True, True)),
    (8192, 8192, (8192, 1), 0, {}, (512, 2080, True, True)),
    # k < 16 and k = 0: one k-step a tile
    (100, 8, (8, 1), 0, {}, (1, 1, True, True)),
    (300, 0, (1, 300), 0, {}, (1, 6, False, True)),
    # lauum's Mᴴ (row-fast) off the 16-byte grid or of odd leading stride
    (1000, 777, (1, 1000), 4, {}, (7, 252, False, False)),
    (1000, 777, (1, 1001), 0, {}, (7, 252, False, False)),
    # the A/B's overrides: a uniform split of each tile, a number of blocks
    (1000, 777, (1, 1000), 0, {"split": 3}, (17, 104, False, True)),
    (2048, 2048, (2048, 1), 0, {"blocks": 132}, (132, 132, True, True)),
])
def test_syrk_launch_plan(n, k, strides, ptr, cut, want):
    assert ksyrk.launch_plan(n, k, strides, ptr, **cut) == want


# ---------------------------------------------------------------------------
# lauum_stream_f32's and trtri_stream_f32's plans (csrc/runs128.cuh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cut,want", [
    # runs for one wave below STREAM_WHOLE_MIN_TILES lower tiles ...
    (128, {}, (1, 8)),
    (1024, {}, (4, 240)),
    (1152, {}, (5, 264)),
    (2048, {}, (25, 262)),
    # ... a block a tile from there (300 tiles at 3072, 2080 at 8192)
    (3072, {}, (0, 300)),
    (8192, {}, (0, 2080)),
    # the A/B's overrides
    (8192, {"blocks": 264}, (1387, 264)),
    (1024, {"whole": True}, (0, 36)),
])
def test_lauum_launch_plan(n, cut, want):
    assert mega.lauum_launch_plan(n, **cut) == want


@pytest.mark.parametrize("n,blocks", [(128, None), (256, None),
                                      (1024, None), (1152, None),
                                      (1152, 7), (2048, None), (3072, 264)])
def test_lauum_runs(n, blocks):
    """Every (lower tile, k-step from its own row block) in exactly one run,
    the runs equal (q steps, the last one short), a split tile's parts in
    k order over consecutive runs, Σ_I (I+1)·(n − 128·I)/16 steps in all,
    and the kernel's closed-form row prefix (LauumPlan::row_start) equal to
    the running sum."""
    q, nb = mega.lauum_launch_plan(n, blocks=blocks)
    runs = mega.lauum_runs(n, q)
    nt = n // 128
    total = sum((i + 1) * (n - 128 * i) // 16 for i in range(nt))
    assert len(runs) == nb == -(-total // q)
    seen = {}
    for b, run in enumerate(runs):
        assert sum(s1 - s0 for _, s0, s1 in run) == (
            q if b < len(runs) - 1 else total - q * (len(runs) - 1))
        for tile, s0, s1 in run:
            seen.setdefault(tile, []).append((b, s0, s1))
    tiles = mega.lauum_tiles(n)
    assert list(seen) == [tile for tile, _ in tiles]
    for tile, steps in tiles:
        i, j = tile
        assert j <= i and steps == (n - 128 * i) // 16
        parts = seen[tile]
        # consecutive runs, consecutive step ranges from 0 to the depth
        assert [b for b, _, _ in parts] == list(
            range(parts[0][0], parts[0][0] + len(parts)))
        assert parts[0][1] == 0 and parts[-1][2] == steps
        assert all(a[2] == b[1] for a, b in zip(parts, parts[1:]))
    prefix = 0
    for i in range(nt + 1):
        closed = 8 * ((nt + 1) * i * (i + 1) // 2
                      - i * (i + 1) * (2 * i + 1) // 6)
        assert closed == prefix
        if i < nt:
            prefix += (i + 1) * 8 * (nt - i)
    assert prefix == total


@pytest.mark.parametrize("n,cut,want", [
    # lauu2_f32 at any n: ⌈(n − 128·i) / 16⌉ steps a tile of row i
    (1, {}, (1, 1)),
    (100, {}, (1, 7)),
    (129, {}, (1, 11)),
    (368, {}, (1, 74)),
    (512, {}, (1, 160)),
    (1000, {}, (4, 231)),
    (368, {"whole": True}, (0, 6)),
])
def test_lauum_launch_plan_ragged(n, cut, want):
    assert mega.lauum_launch_plan(n, **cut) == want


@pytest.mark.parametrize("n,want", [
    # below WAVE // 2 lower tiles, runs for one block an SM ...
    (1, (1, 1)), (128, (1, 8)), (368, (1, 74)), (512, (2, 80)),
    (1000, (7, 132)), (1536, (23, 127)),
    # ... from there lauum_stream_f32's rule (136 tiles at 2048)
    (2048, (25, 262)), (4096, (0, 528)),
])
def test_lauu2_launch_plan(n, want):
    assert leaf.lauu2_launch_plan(n) == want


@pytest.mark.parametrize("n,blocks", [(1, None), (100, None), (129, None),
                                      (368, None), (1000, None),
                                      (1000, 33), (368, 5)])
def test_lauu2_runs(n, blocks):
    """lauu2_f32's plan at any n (its rule, or runs for ``blocks``): every
    (lower tile, k-step) in exactly one run, a split tile's parts in k
    order over consecutive runs, the runs equal (the last one short) and
    within one wave, the kernel's
    closed-form row prefix (LauumPlan::row_start, f steps short) equal to
    the running sum; and the runs' partial products, each clipped at row
    n, summed tile by tile in plan order (as the sum launch does) equal to
    lauu2_plain's lower triangle."""
    q, nb = (mega.lauum_launch_plan(n, blocks=blocks) if blocks
             else leaf.lauu2_launch_plan(n))
    assert nb <= (blocks or ksyrk.WAVE)
    runs = mega.lauum_runs(n, q)
    tiles = mega.lauum_tiles(n)
    total = sum(steps for _, steps in tiles)
    assert len(runs) == nb == -(-total // q)
    seen = {}
    for b, run in enumerate(runs):
        assert sum(s1 - s0 for _, s0, s1 in run) == (
            q if b < len(runs) - 1 else total - q * (len(runs) - 1))
        for tile, s0, s1 in run:
            seen.setdefault(tile, []).append((b, s0, s1))
    assert list(seen) == [tile for tile, _ in tiles]
    for (i, j), steps in tiles:
        assert j <= i and steps == -(-(n - 128 * i) // 16)
        parts = seen[(i, j)]
        assert [b for b, _, _ in parts] == list(
            range(parts[0][0], parts[0][0] + len(parts)))
        assert parts[0][1] == 0 and parts[-1][2] == steps
        assert all(a[2] == b[1] for a, b in zip(parts, parts[1:]))
    nt, prefix = -(-n // 128), 0
    f = (128 * nt - n) // 16
    for i in range(nt + 1):
        closed = 8 * ((nt + 1) * i * (i + 1) // 2
                      - i * (i + 1) * (2 * i + 1) // 6) - f * i * (i + 1) // 2
        assert closed == prefix
        if i < nt:
            prefix += (i + 1) * (8 * (nt - i) - f)
    assert prefix == total
    A = torch.from_numpy(rand((n, n), n))
    T = torch.tril(A)
    B = torch.zeros(n, n)
    for run in runs:
        for (i, j), s0, s1 in run:
            k0, k1 = 128 * i + 16 * s0, min(n, 128 * i + 16 * s1)
            r = slice(128 * i, min(n, 128 * i + 128))
            c = slice(128 * j, 128 * j + 128)
            B[r, c] += T[k0:k1, r].T @ T[k0:k1, c]
    assert_close(torch.tril(B).numpy(), torch.tril(lauu2_plain(A)).numpy(),
                 F32, 2 * n + 3, f"lauu2 runs n={n}")


@pytest.mark.parametrize("n,want", [
    (128, []),
    (1152, [(128, False), (256, False), (512, False), (1024, False)]),
    (4096, [(128, False), (256, False), (512, False), (1024, False),
            (2048, False)]),
    (8192, [(128, False), (256, False), (512, False), (1024, False),
            (2048, True), (4096, True)]),
])
def test_trtri_stream_plan(n, want):
    """A level takes a block a tile from STREAM_WHOLE_MIN_TILES tiles of
    128 in each product (every pair's s/128 x sc/128), else equal runs with
    a sum of the split tiles: one trace row a phase."""
    assert mega.trtri_stream_plan(n) == want
    phases = mega.trtri_stream_phases(n)
    assert phases[0] == "leaves" and phases[-1] == "finish"
    assert len(phases) == 2 + sum(2 if whole else 4 for _, whole in want)


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
# potrf_stream_f32 — replaces ops/pallas/mega.py:potrf_hbm_f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 384])
def test_potrf_stream_twin_vs_pallas(n):
    A = spd_np(n)
    At = torch.from_numpy(A.copy())
    At[np.triu_indices(n, 1)] = np.nan              # the strict upper is unread
    info = potrf_stream_f32(At)
    L, info_j = pmega.potrf_hbm_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == 0
    assert info.dtype == torch.int32 and info.ndim == 0
    got = At.numpy()
    assert np.all(np.triu(got, 1) == 0.0)
    assert_close(got, np.asarray(L), F32, 8 * n, f"potrf_stream n={n}")


@pytest.mark.parametrize("k,value", [(200, -1.0), (7, np.nan)])
def test_potrf_stream_failed_pivot(k, value):
    # info from both; the port's factor stays finite but for an input NaN
    # pivot, and the leading block before the pivot agrees
    A = spd_np(256, cond=10.0)
    A[k, k] = value
    At = torch.from_numpy(A.copy())
    info = potrf_stream_f32(At)
    L, info_j = pmega.potrf_hbm_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == k + 1
    bad = {tuple(ix) for ix in np.argwhere(~np.isfinite(At.numpy()))}
    assert bad <= {(k, k)}
    assert_close(At.numpy()[:k, :k], np.asarray(L)[:k, :k], F32, 8 * 256,
                 "potrf_stream leading block")


def test_potrf_stream_on_a_view():
    A = spd_np(256)
    buf = torch.zeros(256, 384)
    buf[:, 64:320] = torch.from_numpy(A)
    assert int(potrf_stream_f32(buf[:, 64:320])) == 0
    L, _ = pmega.potrf_hbm_f32(jnp.asarray(A))
    assert_close(buf[:, 64:320].numpy(), np.asarray(L), F32, 8 * 256,
                 "potrf_stream view")
    assert torch.all(buf[:, :64] == 0) and torch.all(buf[:, 320:] == 0)


def test_potrf_stream_trace_needs_the_card():
    # the trace buffer is the card's clock: a CPU call with one raises
    A = torch.from_numpy(spd_np(256))
    with pytest.raises(ValueError):
        potrf_stream_f32(A, trace=torch.zeros(2, 8, dtype=torch.int64))


def test_potrf_stream_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        potrf_stream_f32(torch.eye(200))                    # not 128k
    with pytest.raises(ValueError):
        potrf_stream_f32(torch.eye(8320))                   # over 8192
    with pytest.raises(ValueError):
        potrf_stream_f32(torch.eye(256).double())           # f64
    with pytest.raises(ValueError):
        potrf_stream_f32(torch.rand(256, 256).T)            # column-major


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


@pytest.mark.parametrize("n", [1, 33, 100, 300])
def test_trtri_block_twin_ragged_vs_oracle(n):
    # the block recursion's split points at multiples of the leaf, the last
    # block short, against the oracle's column sweep
    L = lower_factor(n, seed=3)
    W, info = trtri_block_f32(torch.from_numpy(L))
    ref, info_o = lapack_ref.trti2("L", "N", torch.from_numpy(L))
    assert int(info) == int(info_o) == 0
    assert np.all(np.triu(W.numpy(), 1) == 0.0)
    assert_close(W.numpy(), ref.numpy(), F32, 60 * n,
                 f"trtri_block n={n} vs oracle")


TRTRI_LEVELS = {
    # n: [(s, [(a0, c0, rows of C)])]
    128: [],
    129: [(128, [(0, 128, 1)])],
    200: [(128, [(0, 128, 72)])],
    512: [(128, [(0, 128, 128), (256, 384, 128)]),
          (256, [(0, 256, 256)])],
    1000: [(128, [(0, 128, 128), (256, 384, 128), (512, 640, 128),
                  (768, 896, 104)]),
           (256, [(0, 256, 256), (512, 768, 232)]),
           (512, [(0, 512, 488)])],
}


@pytest.mark.parametrize("n", sorted(TRTRI_LEVELS))
def test_trtri_block_levels(n):
    assert mega.trtri_levels(n) == TRTRI_LEVELS[n]
