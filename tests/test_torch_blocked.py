"""The whole slice: cholesky_tpu_torch.potrf / logdet against
cholesky_tpu.ops.blocked.potrf / logdet with backend="pallas" (Pallas in
interpret mode), on the same numpy matrices and the same block_size.
On the CPU the port runs its torch tile; ``_KernelTiles`` is also driven
here through the recursion, with the kernel wrappers running their twins.

Bounds are tests/util.assert_close's eps-scaled ones: 8n for a factor
(tests/test_blocked.py), 50n for a log-determinant. For a non-PD input
info must be equal and only the leading (info-1) block is compared."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu.ops import lapack_ref as jref
from cholesky_tpu_torch.ops import blocked as tblocked
from cholesky_tpu_torch.ops import kernels
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401
from tests.util import assert_close

F32 = np.float32


def spd_np(n, cond=50.0, seed=0, dtype=F32):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return (0.5 * (A + A.T)).astype(dtype)


@functools.lru_cache(maxsize=None)
def jax_potrf(n, uplo, block_size, bad=None):
    """The JAX package's blocked potrf on the Pallas tiles (cached: the
    potrf and logdet tests share one interpret-mode run per input)."""
    A = spd_np(n)
    if bad is not None:
        A[bad, bad] = -1.0
    F, info = jblocked.potrf(uplo, jnp.asarray(A), backend="pallas",
                             block_size=block_size)
    return A, np.asarray(F), int(info)


PARITY = [(384, 128, "L"), (384, 128, "U"), (640, 128, "L"),
          (640, 128, "U"), (1000, None, "L")]


@pytest.mark.parametrize("n,bs,uplo", PARITY)
def test_potrf_vs_jax_pallas(n, bs, uplo):
    # 640 = 5 blocks of 128 exercises the identity padding; 1000 with the
    # default block size takes each package's default route
    A, ref, info_j = jax_potrf(n, uplo, bs)
    At = torch.from_numpy(A)
    F, info = ct.potrf(uplo, At, block_size=bs)
    assert int(info) == info_j == 0
    assert_close(F.numpy(), ref, F32, 8 * n, f"potrf n={n} bs={bs} {uplo}")
    assert torch.equal(At, torch.from_numpy(spd_np(n)))   # not mutated


@pytest.mark.parametrize("n,bs,uplo", PARITY)
def test_logdet_vs_jax_pallas(n, bs, uplo):
    # the JAX package's logdet is logdet_from_factor of its potrf
    A, F_j, _ = jax_potrf(n, uplo, bs)
    ref = float(jref.logdet_from_factor(jnp.asarray(F_j)))
    got, info = ct.logdet(uplo, torch.from_numpy(A), block_size=bs)
    assert int(info) == 0
    assert_close(np.asarray(float(got)), np.asarray(ref), F32, 50 * n,
                 f"logdet n={n} {uplo}")


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_nonpd_vs_jax_pallas(uplo):
    n, bad = 384, 200
    A, ref, info_j = jax_potrf(n, uplo, 128, bad)
    F, info = ct.potrf(uplo, torch.from_numpy(A), block_size=128)
    assert int(info) == info_j == bad + 1
    k = bad
    assert_close(F.numpy()[:k, :k], ref[:k, :k], F32, 8 * n,
                 f"potrf nonpd {uplo}")


def test_kernel_tiles_through_the_recursion_on_cpu():
    # _KernelTiles' plumbing (views, transposed views, in-place updates,
    # the wrappers' argument checks) with the wrappers on their twins
    n = 384
    A, ref, _ = jax_potrf(n, "L", 128)
    W = tblocked._pad_identity(torch.from_numpy(A), 128)
    kernels.reset_launch_counts()
    info = tblocked._potrf_lower(W, tblocked._KernelTiles(), 128)
    assert int(info) == 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert_close(np.tril(W.numpy()), np.tril(ref), F32, 8 * n,
                 "kernel tiles on cpu")


@pytest.mark.parametrize("n,kernel", [(100, "potrf_block_f32"),
                                      (384, "potrf_block_f32"),
                                      (512, "potrf_stream_f32"),
                                      (768, "potrf_stream_f32"),
                                      (1152, "potrf_stream_f32")])
def test_kernel_tiles_potf2_routing(n, kernel, monkeypatch):
    # the multiples of 128 from POTRF_STREAM_MIN_N to the stream kernel,
    # the smaller blocks to the block kernel
    seen = []
    for name in ("potrf_block_f32", "potrf_stream_f32"):
        monkeypatch.setattr(tblocked._k, name,
                            lambda A, name=name: seen.append(name))
    tblocked._KernelTiles().potf2(torch.eye(n))
    assert seen == [kernel]


def test_kernel_tiles_refuse_blocks_the_kernels_do_not_take():
    # no whole-matrix kernel takes 200 and the leaf kernel potf2_f32 takes
    # n <= 128 or a multiple of 128 only, as the Pallas leaf asserts
    with pytest.raises(ValueError, match="multiple of 128"):
        tblocked._KernelTiles().potf2(torch.eye(200))


def test_f64_on_the_torch_tile_vs_jax_xla():
    n = 200
    A = spd_np(n, dtype=np.float64)
    F, info = ct.potrf("L", torch.from_numpy(A), block_size=64)
    ref, info_j = jblocked.potrf("L", jnp.asarray(A), backend="xla",
                                 block_size=64)
    assert int(info) == int(info_j) == 0
    assert_close(F.numpy(), np.asarray(ref), np.float64, 8 * n, "f64 potrf")


@pytest.mark.parametrize("backend", ["ref", "torch"])
def test_explicit_cpu_backends(backend):
    A = spd_np(96, dtype=np.float64)
    F, info = ct.potrf("U", torch.from_numpy(A), backend=backend)
    U = np.triu(F.numpy())
    assert int(info) == 0
    assert_close(U.T @ U, A, np.float64, 8 * 96, f"backend={backend}")
    np.testing.assert_array_equal(np.tril(F.numpy(), -1), np.tril(A, -1))


def test_backend_errors():
    A = torch.from_numpy(spd_np(16))
    with pytest.raises(ValueError):
        ct.potrf("L", A, backend="cuda")          # a CPU tensor
    with pytest.raises(ValueError):
        ct.potrf("L", A, backend="pallas")        # not a port backend
    with pytest.raises(ValueError):
        ct.potrf("X", A)
    with pytest.raises(ValueError):
        ct.potrf("L", A, backend="embed")         # a real tensor


def test_empty_matrix():
    F, info = ct.potrf("L", torch.zeros(0, 0))
    assert F.shape == (0, 0) and int(info) == 0
    val, info = ct.logdet("L", torch.zeros(0, 0))
    assert float(val) == 0.0 and int(info) == 0
