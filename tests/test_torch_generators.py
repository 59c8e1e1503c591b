"""cholesky_tpu_torch.rng.latmc: symmetric, with the requested 2-norm
condition number. The port's stream is not JAX's threefry, so these tests
check the contract, not the bits.

Tolerance for the condition number: by Weyl, rounding the matrix to the
dtype moves each eigenvalue by at most ||E||_2 <= n·eps·max|A| <=
n·eps·cond, and the smallest eigenvalue is 1; 4x that is the bound."""

import numpy as np
import pytest
import torch

from cholesky_tpu_torch.rng import latmc


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
