"""cholesky_tpu_torch.rng's generators: latmc (real and complex) and
latmc_pair Hermitian, with the requested 2-norm condition number;
uniform and random_triangular. The port's stream is not JAX's threefry,
so these tests check the contract, not the bits; the interval transform
is held against the JAX package's bit for bit on the same array.

Tolerance for the condition number: by Weyl, rounding the matrix to the
dtype moves each eigenvalue by at most ||E||_2 <= n·eps·max|A| <=
n·eps·cond, and the smallest eigenvalue is 1; 4x that is the bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_tpu.rng import generators as jgen
from cholesky_tpu_torch.rng import (Interval, interval_transform, latmc,
                                    latmc_pair, random_triangular, uniform)
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,cond", [(64, 100.0), (200, 10.0)])
def test_latmc_condition_number(dtype, n, cond):
    A = latmc(torch.Generator().manual_seed(3), n, cond, dtype)
    assert A.dtype == dtype and A.shape == (n, n)
    assert torch.equal(A, A.T)
    lam = np.linalg.eigvalsh(A.double().numpy())
    eps = torch.finfo(dtype).eps
    assert lam[0] > 0
    assert abs(lam[-1] / lam[0] - cond) / cond <= 4 * n * eps * cond
    # the similarity leaves the spectrum [1, cond] in place
    assert abs(lam[0] - 1.0) <= 4 * n * eps * cond


def test_latmc_is_dense_and_deterministic():
    A = latmc(torch.Generator().manual_seed(0), 32, 5.0)
    B = latmc(torch.Generator().manual_seed(0), 32, 5.0)
    C = latmc(torch.Generator().manual_seed(1), 32, 5.0)
    assert torch.equal(A, B)
    assert not torch.equal(A, C)
    assert (A - torch.diag(torch.diag(A))).abs().max() > 0


# ---------------------------------------------------------------------------
# the interval transform, uniform, complex latmc, latmc_pair and
# random_triangular (cholesky_tpu/rng/generators.py:30-172)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interval", list(Interval))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_interval_transform_bit_for_bit_with_jax(interval, dtype):
    # the same [0, 1) array through both packages' transforms
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (64, 48), dtype=dtype))
    want = np.asarray(jgen.uniform(key, (64, 48), dtype, interval))
    got = interval_transform(torch.from_numpy(u.copy()), interval).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniform_on_a_generator(dtype):
    a = uniform(torch.Generator().manual_seed(2), (300, 40), dtype)
    b = uniform(torch.Generator().manual_seed(2), (300, 40), dtype)
    assert a.dtype == dtype and torch.equal(a, b)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    c = uniform(torch.Generator().manual_seed(2), (300, 40), dtype,
                Interval.HALF_OPEN_10)
    assert torch.equal(c, 1.0 - a)


def _check_hpd(re, im, cond, eps):
    n = re.shape[0]
    assert torch.equal(re, re.T) and torch.equal(im, -im.T)
    assert bool((im.diagonal() == 0).all())
    lam = np.linalg.eigvalsh(re.double().numpy() + 1j * im.double().numpy())
    assert lam[0] > 0
    assert abs(lam[-1] / lam[0] - cond) / cond <= 4 * n * eps * cond
    assert abs(lam[0] - 1.0) <= 4 * n * eps * cond


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_latmc_complex_is_hermitian_with_its_condition_number(dtype):
    A = latmc(torch.Generator().manual_seed(4), 64, 50.0, dtype)
    assert A.dtype == dtype and torch.equal(A, A.mH)
    _check_hpd(A.real, A.imag, 50.0, torch.finfo(A.real.dtype).eps)
    assert float(A.imag.abs().max()) > 0          # genuinely complex


@pytest.mark.parametrize("rdtype", [torch.float32, torch.float64])
def test_latmc_pair(rdtype):
    re, im = latmc_pair(torch.Generator().manual_seed(5), 80, 30.0, rdtype)
    assert re.dtype == im.dtype == rdtype
    _check_hpd(re, im, 30.0, torch.finfo(rdtype).eps)
    r2, i2 = latmc_pair(torch.Generator().manual_seed(5), 80, 30.0, rdtype)
    assert torch.equal(re, r2) and torch.equal(im, i2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
@pytest.mark.parametrize("uplo,diag", [("L", "N"), ("U", "U")])
def test_random_triangular(dtype, uplo, diag):
    A = random_triangular(torch.Generator().manual_seed(6), 50, uplo, diag,
                          dtype)
    assert A.dtype == dtype
    other = torch.triu(A, 1) if uplo == "L" else torch.tril(A, -1)
    assert bool((other == 0).all())
    d = A.diagonal()
    if diag == "U":
        assert bool((d == 1).all())
    else:
        assert float(d.abs().min()) >= 1.0        # pushed away from zero
    off = A - torch.diag(d)
    assert float(off.abs().max()) <= 0.5 * 2 ** 0.5
