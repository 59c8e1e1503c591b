"""The GP model of the port (cholesky_tpu_torch.models.gp) against
cholesky_tpu.models.gp on the same numpy data, n = 128 training points with
d = 3 features, f32: the JAX package runs its default route (the Pallas
tiles, in interpret mode), the port its CPU route (the torch tile). The
state crosses between them through ``params_from_jax``.

Bounds are tests/util.assert_close's eps-scaled ones: 50n for the NLL (a
log-determinant plus a quadratic form, as the logdet tests), 3000n for the
gradients and the parameters they move (built on K⁻¹ from potri, the fpe
of tests/test_blocked.py's potri test), 60n for the posterior mean and
variance (two triangular solves)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_tpu.models import gp as jgp
from cholesky_tpu_torch.models import gp
from tests.util import assert_close

F32 = np.float32
N, D = 128, 3


@functools.lru_cache(maxsize=None)
def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, (N, D)).astype(F32)
    y = (np.sin(3.0 * X.sum(axis=1)) + 0.1 * rng.standard_normal(N)
         ).astype(F32)
    Xs = rng.uniform(-1.0, 1.0, (17, D)).astype(F32)
    return X, y, Xs


def torch_data():
    return tuple(torch.from_numpy(a.copy()) for a in data())


@functools.lru_cache(maxsize=None)
def jax_steps(k):
    """The JAX package's params, NLL and info along k train steps."""
    X, y, _ = data()
    p = jgp.GPParams.init()
    out = []
    for _ in range(k):
        p, nll, info = jgp.gp_train_step(p, jnp.asarray(X), jnp.asarray(y))
        out.append((p, float(nll), int(info)))
    return out


def test_params_from_jax():
    p = gp.params_from_jax(jgp.GPParams.init(), device="cpu")
    q = gp.GPParams.init(device="cpu")
    for a, b in zip(p, q):
        assert a.dtype == torch.float32 and a.ndim == 0
        assert torch.equal(a, b)


def test_gp_nll_vs_jax():
    X, y, _ = data()
    ref, info_j = jgp.gp_nll(jgp.GPParams.init(), jnp.asarray(X),
                             jnp.asarray(y))
    Xt, yt, _ = torch_data()
    got, info = gp.gp_nll(gp.GPParams.init(device="cpu"), Xt, yt)
    assert int(info) == int(info_j) == 0
    assert_close(np.asarray(float(got)), np.asarray(float(ref)), F32, 50 * N,
                 "gp_nll")


def test_gp_nll_and_grads_vs_jax():
    X, y, _ = data()
    p0 = jax_steps(1)[0][0]                 # a point off the initial one
    ref, g_ref, info_j = jgp.gp_nll_and_grads(p0, jnp.asarray(X),
                                              jnp.asarray(y))
    Xt, yt, _ = torch_data()
    got, g, info = gp.gp_nll_and_grads(gp.params_from_jax(p0, device="cpu"),
                                     Xt, yt)
    assert int(info) == int(info_j) == 0
    assert_close(np.asarray(float(got)), np.asarray(float(ref)), F32, 50 * N,
                 "gp_nll_and_grads nll")
    for name, a, b in zip(gp.GPParams._fields, g, g_ref):
        assert_close(np.asarray(float(a)), np.asarray(float(b)), F32,
                     3000 * N, f"gradient {name}")


def test_gp_three_train_steps_vs_jax():
    Xt, yt, _ = torch_data()
    p = gp.GPParams.init(device="cpu")
    for step, (p_j, nll_j, info_j) in enumerate(jax_steps(3)):
        p, nll, info = gp.gp_train_step(p, Xt, yt)
        assert int(info) == info_j == 0
        assert_close(np.asarray(float(nll)), np.asarray(nll_j), F32, 50 * N,
                     f"step {step} nll")
        for name, a, b in zip(gp.GPParams._fields, p, p_j):
            assert_close(np.asarray(float(a)), np.asarray(float(b)), F32,
                         3000 * N, f"step {step} {name}")


def test_gp_predict_vs_jax():
    X, y, Xs = data()
    p_j = jax_steps(1)[0][0]
    mean_j, var_j, info_j = jgp.gp_predict(p_j, jnp.asarray(X),
                                           jnp.asarray(y), jnp.asarray(Xs))
    Xt, yt, Xst = torch_data()
    mean, var, info = gp.gp_predict(gp.params_from_jax(p_j, device="cpu"), Xt,
                                  yt, Xst)
    assert int(info) == int(info_j) == 0
    assert mean.shape == var.shape == (17,)
    assert_close(mean.numpy(), np.asarray(mean_j), F32, 60 * N, "mean")
    assert_close(var.numpy(), np.asarray(var_j), F32, 60 * N, "variance")


@pytest.mark.parametrize("backend", ["ref", "torch"])
def test_gp_backends_agree_in_f64(backend):
    # the oracle tier and the blocked torch tile give one model in f64
    Xt, yt, _ = (t.double() for t in torch_data())
    p = gp.GPParams.init(torch.float64, device="cpu")
    nll, g, info = gp.gp_nll_and_grads(p, Xt, yt, backend=backend)
    nll_a, g_a, _ = gp.gp_nll_and_grads(p, Xt, yt)
    assert int(info) == 0
    assert_close(np.asarray(float(nll)), np.asarray(float(nll_a)),
                 np.float64, 50 * N, f"nll {backend}")
    for a, b in zip(g, g_a):
        assert_close(np.asarray(float(a)), np.asarray(float(b)), np.float64,
                     3000 * N, f"gradient {backend}")
