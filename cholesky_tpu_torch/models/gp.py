"""Gaussian-process regression on the library: the port of
``cholesky_tpu/models/gp.py``, the flagship application model.

    NLL(θ) = ½ yᵀK⁻¹y + ½ log|K| + n/2·log 2π,   K = k_θ(X,X) + σₙ²I

- factorization:    potrf (on the card: the blocked recursion over the
                    CUDA kernels)
- solves:           trsm twice through the factor
- log-determinant:  logdet_from_factor
- gradients:        the closed form ∂NLL/∂θ = ½ tr((K⁻¹ − ααᵀ)·∂K/∂θ),
                    α = K⁻¹y, with K⁻¹ from potri: no autograd through the
                    factorization and no optimizer object.

Plain functions on tensors: everything runs on the device of X, and the
parameters are 0-d tensors on that device. One train step runs potrf, two
trsm, potri (trtri then lauum) and logdet together.

Kernel matrices and gradient sums of float32 tensors on the card come
from the hand-written kernels ``rbf_f32`` and ``rbf_grad_f32``
(``ops/kernels/rbf.py``), which make each entry of K from X in registers
and keep no n × n intermediate; every other device and dtype takes the
plain torch passes, the kernels' twin.

Spans (``utils/profiling.py``): a train step or a prediction is the root
``gp.train_step`` or ``gp.predict``; inside, ``gp.kernel_matrix`` and
``gp.gradient_passes``, the kernels' ``kernel.rbf_f32`` and
``kernel.rbf_grad_f32``, and the library's ``api.*`` calls.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cholesky_tpu_torch.ops import api as ops
from cholesky_tpu_torch.ops.kernels import rbf
from cholesky_tpu_torch.utils import profiling


class GPParams(NamedTuple):
    log_amp: torch.Tensor      # log marginal variance
    log_len: torch.Tensor      # log length-scale
    log_noise: torch.Tensor    # log noise stddev

    @staticmethod
    def init(dtype=torch.float32, device="cuda"):
        """The initial parameters, on the card unless the caller names
        another device."""
        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=device)
        return GPParams(scalar(0.0), scalar(0.0), scalar(-1.0))


def params_from_jax(p, device="cuda") -> GPParams:
    """The port's parameters from the JAX package's ``GPParams`` (or any
    triple of numpy-convertible scalars), dtype kept: the state carried
    across the two packages, on the card unless the caller names another
    device."""
    return GPParams(*(torch.from_numpy(np.array(v)).to(device) for v in p))


def _card_f32(X, params) -> bool:
    """Do the RBF kernels take this work: X and the parameters float32 on
    the card. Anything else takes the plain torch passes."""
    return all(t.is_cuda and t.dtype == torch.float32 for t in (X, *params))


_sqdist = rbf.sqdist_plain


@profiling.annotate_function(name="gp.kernel_matrix")
def rbf_kernel(params: GPParams, X1, X2=None):
    X2 = X1 if X2 is None else X2
    if _card_f32(X1, params):
        return rbf.rbf_f32(X1, X2, params.log_amp, params.log_len)
    return rbf.rbf_plain(X1, X2, params.log_amp, params.log_len)


@profiling.annotate_function(name="gp.kernel_matrix")
def _kmatrix(params: GPParams, X, jitter=1e-6):
    if _card_f32(X, params):
        return rbf.rbf_f32(X, X, *params, jitter=jitter)
    return rbf.rbf_plain(X, X, *params, jitter=jitter)


def gp_nll(params: GPParams, X, y, backend: str = "auto"):
    """Negative log marginal likelihood via potrf/trsm/logdet. Returns
    (nll, info)."""
    n = X.shape[0]
    K = _kmatrix(params, X)
    F, info = ops.potrf("L", K, backend=backend)
    ld = ops.logdet_from_factor(F)
    z = ops.trsm("L", "L", "N", "N", 1.0, F, y[:, None], backend=backend)
    quad = torch.sum(z * z)
    return 0.5 * (quad + ld + n * math.log(2.0 * math.pi)), info


def gp_nll_and_grads(params: GPParams, X, y, backend: str = "auto"):
    """NLL and its exact gradients w.r.t. (log_amp, log_len, log_noise):
    ∂NLL/∂θ = ½·Σᵢⱼ Wᵢⱼ·(∂K/∂θ)ᵢⱼ with W = K⁻¹ − ααᵀ, K⁻¹ from potri.
    Returns (nll, GPParams of gradients, info)."""
    n = X.shape[0]
    # each n² buffer is dropped once consumed: at n = 8192 one is 256 MB
    K = _kmatrix(params, X)
    F, info = ops.potrf("L", K, backend=backend)
    del K
    ld = ops.logdet_from_factor(F)
    z = ops.trsm("L", "L", "N", "N", 1.0, F, y[:, None], backend=backend)
    alpha = ops.trsm("L", "L", "T", "N", 1.0, F, z, backend=backend)[:, 0]
    nll = 0.5 * (torch.sum(z * z) + ld + n * math.log(2.0 * math.pi))

    Kinv_tri, _ = ops.potri("L", F, backend=backend)
    del F
    with profiling.annotate("gp.gradient_passes"):
        if _card_f32(X, params):
            # one read of K⁻¹'s lower triangle, K's entries made from X
            g_amp, g_len, g_noise = rbf.rbf_grad_f32(Kinv_tri, alpha, X,
                                                     *params)
            del Kinv_tri
        else:
            Kinv = torch.tril(Kinv_tri) + torch.tril(Kinv_tri, -1).T
            del Kinv_tri
            W = Kinv - alpha[:, None] * alpha[None, :]
            del Kinv

            amp = torch.exp(2.0 * params.log_amp)
            ell2 = torch.exp(2.0 * params.log_len)
            D = _sqdist(X, X)
            Kf = amp * torch.exp(-0.5 * D / ell2)     # noise-free kernel
            dK_damp = 2.0 * Kf                        # ∂K/∂log_amp
            dK_dlen = Kf * (D / ell2)                 # ∂K/∂log_len
            noise = torch.exp(2.0 * params.log_noise)

            g_amp = 0.5 * torch.sum(W * dK_damp)
            g_len = 0.5 * torch.sum(W * dK_dlen)
            g_noise = 0.5 * torch.trace(W) * 2.0 * noise
    return nll, GPParams(g_amp, g_len, g_noise), info


@profiling.annotate_function(name="gp.train_step")
def gp_train_step(params: GPParams, X, y, lr=1e-2, backend: str = "auto"):
    """One gradient step on the hyperparameters. Returns
    (params', nll, info)."""
    nll, g, info = gp_nll_and_grads(params, X, y, backend=backend)
    new = GPParams(*(p - lr * gi for p, gi in zip(params, g)))
    return new, nll, info


@profiling.annotate_function(name="gp.predict")
def gp_predict(params: GPParams, X, y, Xs, backend: str = "auto"):
    """Posterior mean and variance at the test points Xs. Returns
    (mean, var, info)."""
    K = _kmatrix(params, X)
    F, info = ops.potrf("L", K, backend=backend)
    del K
    Ks = rbf_kernel(params, X, Xs)            # (n, m)
    alpha = ops.trsm("L", "L", "T", "N", 1.0, F,
                     ops.trsm("L", "L", "N", "N", 1.0, F, y[:, None],
                              backend=backend), backend=backend)[:, 0]
    mean = Ks.T @ alpha
    V = ops.trsm("L", "L", "N", "N", 1.0, F, Ks, backend=backend)
    var = rbf_kernel(params, Xs, Xs).diagonal() - torch.sum(V * V, dim=0)
    return mean, var, info
