"""Gaussian-process regression with an RBF kernel, written out from the
mathematics: the reference of the GP cells.

    K = a·exp(−‖xᵢ − xⱼ‖² / 2ℓ²) + (σ² + jitter)·I,
    a = exp(2·log_amp), ℓ² = exp(2·log_len), σ² = exp(2·log_noise)
    NLL = ½·yᵀK⁻¹y + ½·log|K| + n/2·log 2π
    ∂NLL/∂θ = ½·Σᵢⱼ Wᵢⱼ·(∂K/∂θ)ᵢⱼ,   W = K⁻¹ − ααᵀ,   α = K⁻¹y

with ∂K/∂log_amp = 2·K_f, ∂K/∂log_len = K_f·D/ℓ², ∂K/∂log_noise = 2σ²·I
(K_f the noise-free kernel, D the squared distances). A train step is one
plain gradient step θ ← θ − lr·∇NLL. The posterior at test points X*:
mean K*ᵀα, variance a − diag(K*ᵀK⁻¹K*).

Parameters are a triple of Python floats (log_amp, log_len, log_noise).
"""

import math

import torch

from benchmark.reference import PRECISIONS, matmul
from benchmark.reference.lapack import potrf_lower


def sqdist(X1, X2):
    """Squared distances, feature by feature (no (n, m, d) temporary)."""
    D = torch.zeros((X1.shape[0], X2.shape[0]), dtype=X1.dtype,
                    device=X1.device)
    for f in range(X1.shape[1]):
        d = X1[:, f, None] - X2[None, :, f]
        D += d * d
    return D


def _hyper(params):
    log_amp, log_len, log_noise = params
    return (math.exp(2.0 * log_amp), math.exp(2.0 * log_len),
            math.exp(2.0 * log_noise))


def nll_and_grads(params, X, y, jitter, prec="f64"):
    """(NLL, [∂NLL/∂log_amp, ∂NLL/∂log_len, ∂NLL/∂log_noise], info) as
    Python floats, computed in ``prec`` from the inputs as given."""
    dt = PRECISIONS[prec]
    X, y = X.to(dt), y.to(dt)
    n = X.shape[0]
    amp, ell2, noise = _hyper(params)
    D = sqdist(X, X)
    Kf = amp * torch.exp(-0.5 * D / ell2)
    K = Kf.clone()
    K.diagonal().add_(noise + jitter)
    L, info = potrf_lower(K, prec)
    del K
    if info:
        return math.nan, [math.nan] * 3, info
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    alpha = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    nll = 0.5 * (float(torch.sum(z * z)) + float(logdet)
                 + n * math.log(2.0 * math.pi))
    eye = torch.eye(n, dtype=dt, device=X.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    del L, eye
    W = matmul(Linv.T, Linv, prec)
    del Linv
    W -= alpha[:, None] * alpha[None, :]
    g_amp = 0.5 * float(torch.sum(W * (2.0 * Kf)))
    g_len = 0.5 * float(torch.sum(W * (Kf * (D / ell2))))
    g_noise = 0.5 * float(torch.trace(W)) * 2.0 * noise
    return nll, [g_amp, g_len, g_noise], 0


def train(params, X, y, lr, steps, jitter, prec="f64"):
    """``steps`` plain gradient steps from ``params``: ([params after each
    step], [NLL at each step's start], [the gradient of each step],
    [info of each step])."""
    after, nlls, grads, infos = [], [], [], []
    p = list(params)
    for _ in range(steps):
        nll, g, info = nll_and_grads(p, X, y, jitter, prec)
        p = [pi - lr * gi for pi, gi in zip(p, g)]
        after.append(p)
        nlls.append(nll)
        grads.append(g)
        infos.append(info)
    return after, nlls, grads, infos


def predict(params, X, y, Xs_list, jitter, prec="f64"):
    """([(mean, var)] at each test set of ``Xs_list``, info), one
    factorization for all of them."""
    dt = PRECISIONS[prec]
    X, y = X.to(dt), y.to(dt)
    amp, ell2, noise = _hyper(params)
    K = amp * torch.exp(-0.5 * sqdist(X, X) / ell2)
    K.diagonal().add_(noise + jitter)
    L, info = potrf_lower(K, prec)
    del K
    if info:
        return [], info
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    alpha = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    out = []
    for Xs in Xs_list:
        Ks = amp * torch.exp(-0.5 * sqdist(X, Xs.to(dt)) / ell2)
        mean = matmul(Ks.T, alpha[:, None], prec)[:, 0]
        V = torch.linalg.solve_triangular(L, Ks, upper=False)
        out.append((mean, amp - torch.sum(V * V, dim=0)))
    return out, 0
