"""Inputs made from ``--seed`` on the device, in a few large calls: the
same seed gives the same inputs, and the program and the reference get
the same tensors."""

import math

import torch


def generator(seed, device, stream=0):
    """A generator on ``device`` for ``seed``; ``stream`` separates the
    draws of one run that must not depend on each other's order."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def dense_spd(g, n, cond, dtype, device):
    """A dense symmetric positive-definite matrix G·Gᵀ/n + s·I, G Gaussian:
    its eigenvalues fill about [s, 4 + s], s set for a 2-norm condition
    number of about ``cond``, and every entry of its factor is live."""
    G = torch.randn(n, n, generator=g, dtype=dtype, device=device)
    A = torch.matmul(G, G.T).div_(n)
    del G
    A.diagonal().add_(4.0 / (cond - 1.0))
    return A.add_(A.T.clone()).mul_(0.5)


def gp_data(g, n, d, dtype, device):
    """(X, y): n points of d features uniform on [−1, 1], and a smooth
    nonlinear target of them with noise of stddev 0.1."""
    X = torch.rand(n, d, generator=g, dtype=dtype, device=device) * 2.0 - 1.0
    w = torch.randn(d, generator=g, dtype=dtype, device=device)
    y = torch.sin(3.0 * (X @ w) / math.sqrt(d)) + 0.1 * torch.randn(
        n, generator=g, dtype=dtype, device=device)
    return X, y


def gp_test_points(g, pool, m, d, dtype, device):
    """``pool`` test sets of m points of d features, uniform on [−1, 1]."""
    return torch.rand(pool, m, d, generator=g, dtype=dtype,
                      device=device) * 2.0 - 1.0
