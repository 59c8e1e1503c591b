"""The plain references against the mathematics: the blocked Cholesky
against LAPACK's, the GP's closed-form gradient against a float64 finite
difference, the posterior against a direct solve, and the TF32 rounding
of the control."""

import math

import pytest
import torch

from benchmark import inputs
from benchmark.reference import gp, lapack, tf32


def spd(n, seed=0):
    return inputs.dense_spd(inputs.generator(seed, "cpu"), n, 100.0,
                            torch.float64, "cpu")


@pytest.mark.parametrize("n", [1, 100, 256, 300, 700])
def test_potrf_lower_matches_lapack(n):
    A = spd(n)
    L, info = lapack.potrf_lower(A)
    assert info == 0
    ref = torch.linalg.cholesky(A)
    assert torch.allclose(L, ref, rtol=0, atol=1e-12 * float(ref.abs().max()))
    assert torch.equal(L, torch.tril(L))


def test_potrf_lower_reads_only_the_lower_triangle():
    A = spd(300)
    B = torch.tril(A) + torch.triu(torch.full_like(A, float("nan")), 1)
    assert torch.equal(lapack.potrf_lower(B)[0], lapack.potrf_lower(A)[0])


def test_potrf_lower_info():
    A = spd(300)
    A[280, 280] = -1.0
    _, info = lapack.potrf_lower(A)
    assert info == 281


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    got = tf32(x)
    # 10 explicit mantissa bits kept, to nearest, ties away from zero
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                            -3.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((tf32(y) - y).abs() / y.abs()).max()
    assert 0 < float(rel) <= 2 ** -11


def test_the_control_is_lower_precision():
    A = spd(700).float()
    ref, _ = lapack.potrf_lower(A, "f64")
    err32 = float((torch.linalg.cholesky(A).double() - ref).abs().max())
    err_tf32 = float((lapack.potrf_lower(A, "tf32")[0].double() - ref)
                     .abs().max())
    assert err_tf32 > 10 * err32


def gp_problem(n=64, d=3, seed=0):
    g = inputs.generator(seed, "cpu")
    X, y = inputs.gp_data(g, n, d, torch.float64, "cpu")
    return X, y


@pytest.mark.parametrize("params", [(0.0, 0.0, -1.0), (0.3, -0.4, -2.0)])
def test_gp_gradient_against_finite_differences(params):
    X, y = gp_problem()
    jitter = 1e-6
    _, g, info = gp.nll_and_grads(list(params), X, y, jitter)
    assert info == 0
    h = 1e-5
    for k in range(3):
        up, down = list(params), list(params)
        up[k] += h
        down[k] -= h
        fd = (gp.nll_and_grads(up, X, y, jitter)[0]
              - gp.nll_and_grads(down, X, y, jitter)[0]) / (2 * h)
        assert g[k] == pytest.approx(fd, rel=1e-6, abs=1e-8)


def test_gp_nll_against_a_direct_formula():
    X, y = gp_problem()
    params, jitter = [0.1, -0.2, -1.5], 1e-6
    nll, _, _ = gp.nll_and_grads(params, X, y, jitter)
    a, l2, s2 = (math.exp(2 * p) for p in params)
    K = a * torch.exp(-0.5 * torch.cdist(X, X) ** 2 / l2)
    K += (s2 + jitter) * torch.eye(len(y), dtype=K.dtype)
    direct = 0.5 * (float(y @ torch.linalg.solve(K, y))
                    + float(torch.logdet(K))
                    + len(y) * math.log(2 * math.pi))
    assert nll == pytest.approx(direct, rel=1e-10)


def test_gp_train_steps():
    X, y = gp_problem()
    p0, lr, jitter = [0.0, 0.0, -1.0], 1e-3, 1e-6
    after, nlls, grads, infos = gp.train(p0, X, y, lr, 2, jitter)
    assert infos == [0, 0]
    assert after[0] == pytest.approx(
        [p - lr * g for p, g in zip(p0, grads[0])])
    assert nlls[1] < nlls[0]


def test_gp_predict_against_a_direct_solve():
    X, y = gp_problem()
    Xs = inputs.gp_test_points(inputs.generator(1, "cpu"), 2, 5, 3,
                               torch.float64, "cpu")
    params, jitter = [0.1, -0.2, -1.5], 1e-6
    out, info = gp.predict(params, X, y, list(Xs), jitter)
    assert info == 0
    a, l2, s2 = (math.exp(2 * p) for p in params)
    K = a * torch.exp(-0.5 * torch.cdist(X, X) ** 2 / l2)
    K += (s2 + jitter) * torch.eye(len(y), dtype=K.dtype)
    for (mean, var), T in zip(out, Xs):
        Ks = a * torch.exp(-0.5 * torch.cdist(X, T) ** 2 / l2)
        assert torch.allclose(mean, Ks.T @ torch.linalg.solve(K, y),
                              rtol=1e-10, atol=1e-12)
        direct = a - torch.sum(Ks * torch.linalg.solve(K, Ks), dim=0)
        assert torch.allclose(var, direct, rtol=1e-8, atol=1e-12)
