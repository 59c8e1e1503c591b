"""The trtri / lauum / potri / trsm slice of the port against the JAX package,
on the same numpy inputs:

- the oracle tier (cholesky_tpu_torch.ops.lapack_ref / blas_ref) against
  cholesky_tpu.ops.lapack_ref / blas_ref, f32 and f64;
- the plain twins of the three new kernels (trtri_stream_f32,
  lauum_stream_f32, lauu2_f32) against the Pallas kernels they replace,
  run in interpret mode as the JAX package's own tests run them;
- the blocked routines against cholesky_tpu.ops.blocked with
  backend="pallas", at n = 384 / 640 with block_size=128 and on the
  default route, and ``_KernelTiles`` driven through the recursions on
  the CPU (the wrappers run their twins; no launch is counted).

Bounds are tests/util.assert_close's eps-scaled ones, with the JAX
package's own fpe for each routine (tests/test_blocked.py): 60n for a
triangular inverse and a triangular solve, 2n+3 for lauum (a product of
depth n), 3000n for potri."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu.ops import blas_ref as jblas
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu.ops import lapack_ref as jref
from cholesky_tpu.ops.pallas import leaf as pleaf
from cholesky_tpu.ops.pallas import mega as pmega
from cholesky_tpu_torch.ops import blas_ref as tblas
from cholesky_tpu_torch.ops import blocked as tblocked
from cholesky_tpu_torch.ops import kernels
from cholesky_tpu_torch.ops import lapack_ref as tref
from tests.util import assert_close

F32 = np.float32
DTYPES = {"f32": np.float32, "f64": np.float64}


def spd_np(n, cond=30.0, seed=0, dtype=F32):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return (0.5 * (A + A.T)).astype(dtype)


def factor_np(n, seed=0, dtype=F32):
    """A row-major Cholesky factor with the caller's garbage above it: only
    the lower triangle may be read."""
    L = np.linalg.cholesky(spd_np(n, seed=seed, dtype=np.float64))
    G = np.random.default_rng(seed + 100).standard_normal((n, n))
    return np.ascontiguousarray(L + np.triu(G, 1), dtype)


def tri_np(n, seed=1, dtype=F32):
    """A well-conditioned matrix for triangular use: dominant diagonal,
    both triangles full."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.5, 0.5, (n, n)) / np.sqrt(n)
    A[np.diag_indices(n)] = np.sign(A.diagonal()) + A.diagonal()
    return A.astype(dtype)


def tri(uplo):
    return np.tril if uplo == "L" else np.triu


# ---------------------------------------------------------------------------
# the oracle tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo,diag", [("L", "N"), ("L", "U"), ("U", "N"),
                                       ("U", "U")])
@pytest.mark.parametrize("name", ["trtri", "trtri2"])
def test_trtri_oracle(dt, uplo, diag, name):
    n = 40
    A = tri_np(n, dtype=DTYPES[dt])
    got, it = getattr(tref, name)(uplo, diag, torch.from_numpy(A.copy()))
    ref, ij = getattr(jref, name)(uplo, diag, jnp.asarray(A))
    assert int(it) == int(ij) == 0
    # the whole matrix: the opposite strict triangle passes through
    assert_close(got.numpy(), np.asarray(ref), DTYPES[dt], 60 * n,
                 f"{name} {dt} {uplo}{diag}")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("name", ["lauu2", "lauum"])
def test_lauum_oracle(dt, uplo, name):
    n = 40
    A = tri_np(n, dtype=DTYPES[dt])
    got = getattr(tref, name)(uplo, torch.from_numpy(A.copy())).numpy()
    ref = np.asarray(getattr(jref, name)(uplo, jnp.asarray(A)))
    assert_close(got, ref, DTYPES[dt], 2 * n + 3, f"{name} {dt} {uplo}")
    other = np.triu if uplo == "L" else np.tril
    k = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(got, k), other(A, k))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potri_oracle(dt, uplo):
    n = 40
    F = factor_np(n, dtype=DTYPES[dt])
    F = F if uplo == "L" else np.ascontiguousarray(F.T)
    got, it = tref.potri(uplo, torch.from_numpy(F.copy()))
    ref, ij = jref.potri(uplo, jnp.asarray(F))
    assert int(it) == int(ij) == 0
    assert_close(got.numpy(), np.asarray(ref), DTYPES[dt], 3000 * n,
                 f"potri {dt} {uplo}")


COMBOS = [(s, u, t, d) for s in "LR" for u in "LU" for t in "NT"
          for d in "NU"]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("side,uplo,trans,diag", COMBOS)
def test_trsm_oracle(dt, side, uplo, trans, diag):
    n, m = 40, 7
    A = tri_np(n, dtype=DTYPES[dt])
    B = np.random.default_rng(3).standard_normal(
        (n, m) if side == "L" else (m, n)).astype(DTYPES[dt])
    got = tblas.trsm(side, uplo, trans, diag, 0.9, torch.from_numpy(A),
                     torch.from_numpy(B))
    ref = jblas.trsm(side, uplo, trans, diag, 0.9, jnp.asarray(A),
                     jnp.asarray(B))
    assert_close(got.numpy(), np.asarray(ref), DTYPES[dt], 60 * n,
                 f"blas_ref trsm {dt} {side}{uplo}{trans}{diag}")


# ---------------------------------------------------------------------------
# the twins of the new kernels against the Pallas kernels they replace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 384])
def test_trtri_stream_twin_vs_pallas(n):
    # one zero diagonal: info 10 from both, read as 1, output finite
    L = factor_np(n)
    L[9, 9] = 0.0
    W, info = kernels.trtri_stream_f32(torch.from_numpy(L))
    ref, info_j = pmega.trtri_hbm_f32(jnp.asarray(L))
    assert int(info) == int(info_j) == 10
    got = W.numpy()
    assert np.isfinite(got).all() and np.all(np.triu(got, 1) == 0.0)
    assert_close(got, np.asarray(ref), F32, 60 * n, f"trtri_stream n={n}")


def test_lauum_stream_twin_vs_pallas():
    n = 256
    L = factor_np(n)
    ref = np.asarray(pmega.lauum_hbm_f32(jnp.asarray(L)))
    L[np.triu_indices(n, 1)] = np.nan           # the strict upper is unread
    got = kernels.lauum_stream_f32(torch.from_numpy(L)).numpy()
    assert np.isfinite(got).all() and np.all(np.triu(got, 1) == 0.0)
    assert_close(got, ref, F32, 2 * n + 3, "lauum_stream")


@pytest.mark.parametrize("n", [128, 100, 200])
def test_lauu2_twin_vs_pallas(n):
    A = factor_np(n)
    got = kernels.lauu2_f32(torch.from_numpy(A)).numpy()
    ref = np.asarray(pleaf.lauu2_f32(jnp.asarray(A)))
    assert_close(np.tril(got), np.tril(ref), F32, 2 * n + 3, "lauu2")
    iu = np.triu_indices(n, 1)                  # passed through, bit for bit
    np.testing.assert_array_equal(got[iu], A[iu])
    np.testing.assert_array_equal(ref[iu], A[iu])


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        kernels.trtri_stream_f32(torch.eye(200))         # not 128k
    with pytest.raises(ValueError):
        kernels.trtri_stream_f32(torch.eye(8320))        # over 8192
    with pytest.raises(ValueError):
        kernels.lauum_stream_f32(torch.eye(256).double())
    with pytest.raises(ValueError):
        kernels.lauum_stream_f32(torch.rand(256, 256).T)  # column-major
    with pytest.raises(ValueError):
        kernels.lauu2_f32(torch.eye(256).double())      # f64


# ---------------------------------------------------------------------------
# the blocked routines against the JAX package's Pallas tiles
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_trtri(n, bs, uplo, diag):
    A = tri_np(n, seed=n)
    R, info = jblocked.trtri(uplo, diag, jnp.asarray(A), backend="pallas",
                             block_size=bs)
    return A, np.asarray(R), int(info)


@functools.lru_cache(maxsize=None)
def jax_lauum(n, bs, uplo):
    A = tri_np(n, seed=n + 1)
    R = jblocked.lauum(uplo, jnp.asarray(A), backend="pallas", block_size=bs)
    return A, np.asarray(R)


TRTRI = [(384, 128, "L", "N"), (640, 128, "U", "N"), (384, 128, "U", "U"),
         (640, 128, "L", "U"), (640, None, "L", "N")]


@pytest.mark.parametrize("n,bs,uplo,diag", TRTRI)
def test_trtri_vs_jax_pallas(n, bs, uplo, diag):
    A, ref, info_j = jax_trtri(n, bs, uplo, diag)
    At = torch.from_numpy(A.copy())
    R, info = ct.trtri(uplo, diag, At, block_size=bs)
    assert int(info) == info_j == 0
    assert_close(R.numpy(), ref, F32, 60 * n, f"trtri n={n} {uplo}{diag}")
    assert torch.equal(At, torch.from_numpy(A))           # not mutated
    if diag == "U":                 # the unit diagonal passes through
        np.testing.assert_array_equal(np.diag(R.numpy()), np.diag(A))


LAUUM = [(384, 128, "L"), (640, 128, "U"), (640, None, "L")]


@pytest.mark.parametrize("n,bs,uplo", LAUUM)
def test_lauum_vs_jax_pallas(n, bs, uplo):
    A, ref = jax_lauum(n, bs, uplo)
    got = ct.lauum(uplo, torch.from_numpy(A.copy()), block_size=bs).numpy()
    assert_close(tri(uplo)(got), tri(uplo)(ref), F32, 2 * n + 3,
                 f"lauum n={n} {uplo}")
    k = 1 if uplo == "L" else -1
    other = np.triu if uplo == "L" else np.tril
    np.testing.assert_array_equal(other(got, k), other(A, k))


@pytest.mark.parametrize("n,bs,uplo", [(384, 128, "L"), (640, 128, "U"),
                                       (384, None, "L")])
def test_potri_vs_jax_pallas(n, bs, uplo):
    F = factor_np(n, seed=2)
    F = F if uplo == "L" else np.ascontiguousarray(F.T)
    ref, info_j = jblocked.potri(uplo, jnp.asarray(F), backend="pallas",
                                 block_size=bs)
    got, info = ct.potri(uplo, torch.from_numpy(F.copy()), block_size=bs)
    assert int(info) == int(info_j) == 0
    assert_close(tri(uplo)(got.numpy()), tri(uplo)(np.asarray(ref)), F32,
                 3000 * n, f"potri n={n} {uplo}")


@pytest.mark.parametrize("side,uplo,trans,diag", COMBOS)
def test_trsm_vs_jax_pallas(side, uplo, trans, diag):
    n, m = 384, 5
    A = tri_np(n, seed=4)
    B = np.random.default_rng(5).standard_normal(
        (n, m) if side == "L" else (m, n)).astype(F32)
    ref = jblocked.trsm(side, uplo, trans, diag, 0.9, jnp.asarray(A),
                        jnp.asarray(B), backend="pallas", block_size=128)
    Bt = torch.from_numpy(B.copy())
    got = ct.trsm(side, uplo, trans, diag, 0.9, torch.from_numpy(A), Bt,
                  block_size=128)
    assert_close(got.numpy(), np.asarray(ref), F32, 60 * n,
                 f"trsm {side}{uplo}{trans}{diag}")
    assert torch.equal(Bt, torch.from_numpy(B))           # not mutated


def test_trsm_default_route_vs_jax_pallas():
    # 640 on each package's default route: leaf_nb 128 there, 128 on the
    # port's torch tile; the identity padding is not needed at 640
    n = 640
    A = tri_np(n, seed=6)
    B = np.random.default_rng(7).standard_normal((n, 3)).astype(F32)
    ref = jblocked.trsm("L", "L", "T", "N", 1.0, jnp.asarray(A),
                        jnp.asarray(B), backend="pallas")
    got = ct.trsm("L", "L", "T", "N", 1.0, torch.from_numpy(A),
                  torch.from_numpy(B))
    assert_close(got.numpy(), np.asarray(ref), F32, 60 * n, "trsm default")


def test_trsm_backends_and_arguments():
    A = torch.from_numpy(tri_np(50, dtype=np.float64))
    B = torch.from_numpy(np.random.default_rng(8).standard_normal((50, 4)))
    ref = tblas.trsm("L", "U", "N", "N", 2.0, A, B)
    for backend in ("ref", "torch"):
        got = ct.trsm("L", "U", "N", "N", 2.0, A, B, backend=backend)
        assert_close(got.numpy(), ref.numpy(), np.float64, 60 * 50, backend)
    # a tensor alpha on the CPU takes the oracle, as JAX sends a traced one
    assert torch.equal(ct.trsm("L", "L", "N", "N", torch.tensor(2.0), A, B),
                       tblas.trsm("L", "L", "N", "N", 2.0, A, B))
    with pytest.raises(ValueError):
        ct.trsm("L", "L", "N", "N", 1.0, A, B[:40])            # dims
    with pytest.raises(ValueError):
        ct.trsm("L", "L", "N", "N", 1.0, A, B, backend="cuda")  # CPU tensor


@pytest.mark.parametrize("name,dt", [("trsm", F32), ("strsm", F32),
                                     ("dtrsm", np.float64)])
@pytest.mark.parametrize("side,trans", [("L", "N"), ("L", "T"), ("R", "N"),
                                        ("R", "T")])
def test_trsm_tensor_alpha_vs_jax(name, dt, side, trans):
    # a 0-d tensor alpha goes to the oracle on the CPU in both packages
    A = np.eye(8, dtype=dt) * 2.0
    B = np.ones((8, 3) if side == "L" else (3, 8), dtype=dt)
    ref = jblocked.trsm(side, "L", trans, "N", jnp.asarray(0.5, dtype=dt),
                        jnp.asarray(A), jnp.asarray(B))
    got = getattr(ct, name)(side, "L", trans, "N",
                            torch.tensor(0.5, dtype=torch.from_numpy(A).dtype),
                            torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.from_numpy(A).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got[0, 0]) == 0.25
    # a wider triangle: the same as the port's own Python-number route
    T = tri_np(40, seed=9, dtype=dt)
    R = np.random.default_rng(10).standard_normal(
        (40, 3) if side == "L" else (3, 40)).astype(dt)
    ref = jblocked.trsm(side, "L", trans, "N", jnp.asarray(0.5, dtype=dt),
                        jnp.asarray(T), jnp.asarray(R))
    got = getattr(ct, name)(side, "L", trans, "N", torch.tensor(0.5),
                            torch.from_numpy(T), torch.from_numpy(R))
    assert_close(got.numpy(), np.asarray(ref), dt, 60 * 40,
                 f"{name} tensor alpha {side}{trans}")


# ---------------------------------------------------------------------------
# _KernelTiles through the recursions, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("allow_mega", [False, True])
def test_kernel_tiles_through_trtri_and_lauum_on_cpu(allow_mega):
    # views, transposed views, in-place updates and the wrappers' checks,
    # with the wrappers on their twins; allow_mega sends the whole 384
    # block to trtri_block_f32 / lauum_stream_f32
    n = 384
    t = tblocked._KernelTiles()
    kernels.reset_launch_counts()
    A, ref, _ = jax_trtri(n, 128, "L", "N")
    W = tblocked._pad_identity(torch.tril(torch.from_numpy(A)), 128)
    info = tblocked._trtri_lower(W, t, 128, False, allow_mega)
    assert int(info) == 0
    assert_close(np.tril(W.numpy()), np.tril(ref), F32, 60 * n,
                 "kernel tiles trtri")
    A, ref = jax_lauum(n, 128, "L")
    W = tblocked._pad_identity(torch.from_numpy(A), 128)
    tblocked._lauum_lower(W, t, 128, allow_mega)
    assert_close(np.tril(W.numpy()), np.tril(ref), F32, 2 * n + 3,
                 "kernel tiles lauum")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_kernel_tiles_route_by_size():
    t = tblocked._KernelTiles()
    kernels.reset_launch_counts()
    # potrf above 1024 takes the stream kernel (here its twin)
    A = torch.eye(1152) * 4.0
    assert int(t.potf2(A)) == 0 and torch.equal(A, torch.eye(1152) * 2.0)
    # above 1024 the stream kernel takes the inverse (here its twin)
    L = torch.eye(1152) * 2.0
    W, info = t.trti2(L)
    assert int(info) == 0 and torch.equal(W, torch.eye(1152) * 0.5)
    # the unit-diagonal trick keeps L's own diagonal
    W, info = t.trti2(torch.eye(256) * 3.0, unit=True)
    assert int(info) == 0 and torch.equal(W, torch.eye(256) * 3.0)
    # the leaf kernel lauu2_f32 takes any n (here its twin)
    assert torch.equal(t.lauu2(torch.eye(1100) * 2.0), torch.eye(1100) * 4.0)
    # no whole-matrix kernel takes 1100, and the leaf kernel trti2_f32
    # takes n <= 128 or a multiple of 128 only, as the Pallas leaf asserts
    with pytest.raises(ValueError, match="multiple of 128"):
        t.trti2(torch.eye(1100))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)



@pytest.mark.parametrize("n,tiles,allow_mega,p", [
    (640, "kernel", True, 640),      # one whole-matrix kernel: no padding
    (2048, "kernel", True, 2048),
    (640, "kernel", False, 1024),    # a block size: the recursion's padding
    (1100, "kernel", True, 1536),    # no kernel takes 1100 whole
    (640, "torch", True, 1024)])
def test_working_copy_pads_only_for_the_recursion(n, tiles, allow_mega, p):
    t = tblocked._KernelTiles() if tiles == "kernel" else tblocked._TorchTiles()
    A = torch.eye(n) * 2.0
    W = tblocked._working_copy(A, t, 512, "potrf", allow_mega)
    assert W.shape == (p, p) and W.is_contiguous()
    assert torch.equal(W, torch.eye(p) * torch.where(torch.arange(p) < n,
                                                     2.0, 1.0))
