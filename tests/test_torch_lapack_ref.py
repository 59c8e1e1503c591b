"""The port's oracle tier (cholesky_tpu_torch/ops/lapack_ref.py) against
the JAX package's (cholesky_tpu/ops/lapack_ref.py): the same numpy inputs
through both, f32 and f64, lower and upper. Tolerances are the repo's
eps-scaled analytic bounds (tests/util.py) with the flops-per-element
factors the JAX package's own tests use: 8n for a Cholesky factor, 40n
for a triangular inverse, 50n for a log-determinant."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_tpu.ops import lapack_ref as jref
from cholesky_tpu_torch.ops import lapack_ref as tref
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401
from tests.util import assert_close

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                      torch.float64)}


def spd_np(n, cond=50.0, seed=0):
    """SPD matrix with eigenvalues spread over [1, cond]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return 0.5 * (A + A.T)


def tri_np(n, lower, seed=1):
    """Triangular matrix with a dominant diagonal (well conditioned)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.5, 0.5, (n, n))
    A[np.diag_indices(n)] = np.sign(A.diagonal()) + A.diagonal()
    return np.tril(A) if lower else np.triu(A)


def both(fn_t, fn_j, A, np_dt, t_dt, *args):
    """Run the same numpy matrix through the port and the JAX package."""
    A = np.asarray(A, np_dt)
    got, info_t = fn_t(*args, torch.from_numpy(A.copy()))
    ref, info_j = fn_j(*args, jnp.asarray(A))
    return got.numpy(), int(info_t), np.asarray(ref), int(info_j)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potf2(dt, uplo):
    n = 48
    got, it, ref, ij = both(tref.potf2, jref.potf2, spd_np(n), *DTYPES[dt],
                            uplo)
    assert it == ij == 0
    assert_close(got, ref, DTYPES[dt][0], 8 * n, f"potf2 {dt} {uplo}")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potf2_nonpd_freezes(dt, uplo):
    # equal info, and the reference's freeze: the failing column is written
    # with its pivot clamped to 1, every later column keeps its input
    n, bad = 40, 5
    A = spd_np(n, cond=10.0)
    A[bad, bad] = -1.0
    got, it, ref, ij = both(tref.potf2, jref.potf2, A, *DTYPES[dt], uplo)
    assert it == ij == bad + 1
    assert np.isfinite(got).all()
    assert_close(got, ref, DTYPES[dt][0], 8 * n, f"potf2 nonpd {dt} {uplo}")
    Ad = np.asarray(A, DTYPES[dt][0])
    view = (lambda X: X) if uplo == "L" else (lambda X: X.T)
    np.testing.assert_array_equal(view(got)[:, bad + 1:],
                                  view(Ad)[:, bad + 1:])


def test_potf2_nan_pivot():
    n = 32
    A = spd_np(n, cond=10.0)
    A[7, 7] = np.nan
    got, it, ref, ij = both(tref.potf2, jref.potf2, A, np.float32,
                            torch.float32, "L")
    # NaN-safe test: equal info. The JAX sweep's masked matvec (0·NaN)
    # also smears the NaN over row 7; the port's output stays finite
    assert it == ij == 8
    assert np.isfinite(got).all()
    assert_close(got[:7, :7], ref[:7, :7], np.float32, 8 * n, "potf2 nan")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trti2(dt, uplo, diag):
    n = 40
    T = tri_np(n, uplo == "L")
    got, it, ref, ij = both(tref.trti2, jref.trti2, T, *DTYPES[dt], uplo,
                            diag)
    assert it == ij == 0
    assert_close(got, ref, DTYPES[dt][0], 40 * n, f"trti2 {dt} {uplo}{diag}")


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_trti2_zero_diag(uplo):
    # a zero diagonal sets info, is treated as 1, and does not freeze
    n = 32
    T = tri_np(n, uplo == "L")
    T[9, 9] = 0.0
    got, it, ref, ij = both(tref.trti2, jref.trti2, T, np.float64,
                            torch.float64, uplo, "N")
    assert it == ij == 10
    assert np.isfinite(got).all()
    assert_close(got, ref, np.float64, 40 * n, f"trti2 zero diag {uplo}")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_blocked_ref(dt, uplo):
    n = 48
    A = np.asarray(spd_np(n), DTYPES[dt][0])
    got, it = tref.potrf(uplo, torch.from_numpy(A.copy()), block_size=16)
    ref, ij = jref.potrf(uplo, jnp.asarray(A), block_size=16)
    assert int(it) == int(ij) == 0
    assert_close(got.numpy(), np.asarray(ref), DTYPES[dt][0], 8 * n,
                 f"potrf {dt} {uplo}")


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_blocked_ref_nonpd(uplo):
    # equal info; only the leading (info-1) block is defined past a failure
    n, bad = 48, 37
    A = spd_np(n, cond=10.0)
    A[bad, bad] = -1.0
    got, it = tref.potrf(uplo, torch.from_numpy(A.copy()), block_size=16)
    ref, ij = jref.potrf(uplo, jnp.asarray(A), block_size=16)
    assert int(it) == int(ij) == bad + 1
    k = bad
    assert_close(got.numpy()[:k, :k], np.asarray(ref)[:k, :k], np.float64,
                 8 * n, f"potrf nonpd {uplo}")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_logdet(dt, uplo):
    n = 40
    A = np.asarray(spd_np(n), DTYPES[dt][0])
    got, it = tref.logdet(uplo, torch.from_numpy(A.copy()), block_size=16)
    ref, ij = jref.logdet(uplo, jnp.asarray(A), block_size=16)
    assert int(it) == int(ij) == 0
    assert_close(got.numpy(), np.asarray(ref), DTYPES[dt][0], 50 * n,
                 f"logdet {dt} {uplo}")


def test_logdet_from_factor_takes_a_diagonal():
    d = np.array([1.0, 2.0, 4.0])
    got = tref.logdet_from_factor(torch.from_numpy(d))
    ref = jref.logdet_from_factor(jnp.asarray(d))
    assert abs(float(got) - float(ref)) < 1e-12


def test_inputs_not_modified_and_square_checked():
    A = torch.from_numpy(spd_np(16))
    A0 = A.clone()
    tref.potf2("U", A)
    tref.trti2("L", "N", A)
    tref.potrf("L", A, block_size=4)
    assert torch.equal(A, A0)
    with pytest.raises(ValueError):
        tref.potf2("L", torch.zeros(3, 4))
