"""Distributed GP training step: dp (batch) × mp (matrix) over a 2-D
process mesh.

The counterpart of ``cholesky_tpu/models/gp_dist.py:52-141``, the
multi-device version of ``models/gp.py``: a batch of independent GP
problems is spread over the dp index of a :class:`~cholesky_tpu_torch.
parallel.launch.Mesh2D`, and within each problem the kernel matrix is
block-cyclic over its mp group, whose ranks factor it, take its
log-determinant and solve through it together (``parallel/potrf.py``,
``parallel/trsm.py``).

Gradients use the large-scale GP estimator of the JAX package: exact
quadratic terms αᵀ(∂K)α plus Hutchinson trace probes tr(K⁻¹∂K) ≈
E_z[(K⁻¹z)ᵀ(∂K)z] with the caller's Rademacher z, all linear algebra
through the distributed factor.
"""

from __future__ import annotations

import math

import torch

from cholesky_tpu_torch import config  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.models.gp import GPParams, _kmatrix, _sqdist
from cholesky_tpu_torch.parallel import comm
from cholesky_tpu_torch.parallel.blockcyclic import distribute
from cholesky_tpu_torch.parallel.potrf import _logdet_local, potrf_dist
from cholesky_tpu_torch.parallel.trsm import trsm_factor_dist
from cholesky_tpu_torch.utils.errors import check


def make_gp_train_step(mesh, n_train: int, n_features: int, batch: int,
                       nb: int = 8, n_probes: int = 2, lr: float = 1e-2,
                       dtype=torch.float32):
    """The distributed GP train step of this rank on ``mesh`` (a
    ``launch.Mesh2D``): step(params, X, y, probes) → (params', mean nll,
    infos), the same on every rank of the world.

    Each rank passes its dp shard: X (batch/dp, n_train, n_features), y
    (batch/dp, n_train) and the Rademacher probes (batch/dp, n_train,
    n_probes), the global batch's rows i_dp·batch/dp on. The ranks of one
    mp group pass the same shard. infos is the global batch's (batch,)
    int32 potrf infos, in batch order.

    Collectives per step: for each local problem, in the same order on
    every rank of the mp group, potrf_dist's, one all_reduce of the
    log-determinant and the two solves' (the JAX program batches them
    with vmap: here they count once a problem); then one all_reduce of
    the nll and gradient sums and one all_gather of the infos over the
    dp group."""
    check(batch % mesh.dp == 0, "make_gp_train_step", 4,
          f"batch {batch} is not a multiple of dp {mesh.dp}")
    local_batch = batch // mesh.dp

    def factor_solve(K, rhs):
        """(K⁻¹·rhs, log|K|, info) through the factor spread over the mp
        group. A failed pivot stops the factor on every rank of the group
        at the same step, and the solves still run on the partial factor,
        as in the JAX program, so every rank enters the same
        collectives."""
        fbc, info = potrf_dist(distribute(K, mesh.mp_group, nb=nb))
        ld = _logdet_local(fbc)
        x = trsm_factor_dist(fbc, trsm_factor_dist(fbc, rhs, "N"), "T")
        return x, ld, info

    def step(params: GPParams, X, y, probes):
        check(X.shape == (local_batch, n_train, n_features)
              and X.dtype == dtype, "make_gp_train_step", 2,
              f"X must be ({local_batch}, {n_train}, {n_features}) "
              f"{dtype}, got {tuple(X.shape)} {X.dtype}")
        amp = torch.exp(2.0 * params.log_amp)
        ell2 = torch.exp(2.0 * params.log_len)
        noise = torch.exp(2.0 * params.log_noise)
        sums = torch.zeros(4, dtype=dtype, device=X.device)
        infos = []
        for b in range(local_batch):
            Xb, yb, zb = X[b], y[b], probes[b]
            rhs = torch.cat([yb[:, None], zb], dim=1)
            sol, ld, info = factor_solve(_kmatrix(params, Xb), rhs)
            infos.append(info)
            alpha, U = sol[:, 0], sol[:, 1:]      # K⁻¹y, K⁻¹z
            nll = 0.5 * (torch.dot(yb, alpha) + ld
                         + n_train * math.log(2.0 * math.pi))

            # per-θ kernel derivative actions
            D = _sqdist(Xb, Xb)
            Kf = amp * torch.exp(-0.5 * D / ell2)

            def grad_of(dK):
                # ½[tr(K⁻¹dK) − αᵀdKα], the trace by Hutchinson probes
                tr = torch.mean(torch.sum(U * (dK @ zb), dim=0))
                return 0.5 * (tr - torch.dot(alpha, dK @ alpha))

            g_amp = grad_of(2.0 * Kf)
            g_len = grad_of(Kf * (D / ell2))
            # noise: dK = 2σₙ²·I, tr(K⁻¹dK) by the probes, αᵀα exact
            tr_n = torch.mean(torch.sum(U * zb, dim=0))
            g_noise = 0.5 * (tr_n - torch.dot(alpha, alpha)) * 2.0 * noise
            sums += torch.stack([nll, g_amp, g_len, g_noise])
        comm.all_reduce(sums, mesh.dp_group)
        nll, *grads = sums / batch
        all_infos = torch.cat(comm.all_gather(
            torch.stack(infos).to(torch.int32), mesh.dp_group))
        new = GPParams(*(p - lr * g for p, g in zip(params, grads)))
        return new, nll, all_infos

    return step
