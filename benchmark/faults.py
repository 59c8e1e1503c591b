"""Faults planted under a cell's timed path, to show that its check fails
them: ``plant(call, fault)`` patches the program's entry point for as
long as the context lasts. Used by ``readings.py`` on the card and by the
tests on the CPU; a benchmark run plants nothing."""

import contextlib

import torch

import cholesky_tpu_torch as ct
from cholesky_tpu_torch.models import gp

def _potrf_altered(potrf):
    def fault(uplo, A, *args, **kwargs):
        F, info = potrf(uplo, A, *args, **kwargs)
        F = F.clone()
        F[-1, 0] += 1e-2 * F.abs().max()      # one entry, where produced
        return F, info
    return fault


def _train_unchanged(step):
    def fault(params, X, y, *args, **kwargs):
        _, nll, info = step(params, X, y, *args, **kwargs)
        return params, nll, info
    return fault


def _train_half(nll_and_grads):
    def fault(params, X, y, *args, **kwargs):
        h = X.shape[0] // 2
        nll, g, info = nll_and_grads(params, X[:h], y[:h], *args, **kwargs)
        return 2 * nll, gp.GPParams(*(2 * v for v in g)), info
    return fault


def _train_altered(step):
    def fault(params, X, y, *args, **kwargs):
        new, nll, info = step(params, X, y, *args, **kwargs)
        return new, nll * (1 + 1e-3), info
    return fault


def _predict_half(predict):
    def fault(params, X, y, Xs, *args, **kwargs):
        h = Xs.shape[0] // 2
        mean, var, info = predict(params, X, y, Xs[:h], *args, **kwargs)
        rest = Xs.shape[0] - h                # the mean taken over the rest
        return (torch.cat([mean, mean.mean().expand(rest)]),
                torch.cat([var, var.mean().expand(rest)]), info)
    return fault


def _predict_altered(predict):
    def fault(params, X, y, Xs, *args, **kwargs):
        mean, var, info = predict(params, X, y, Xs, *args, **kwargs)
        mean = mean.clone()
        mean[0] += 1e-2 * mean.abs().max()
        return mean, var, info
    return fault


_PLANTS = {
    ("potrf", "altered"): (ct, "potrf", _potrf_altered),
    ("gp_train_step", "unchanged"): (gp, "gp_train_step", _train_unchanged),
    ("gp_train_step", "half_batch"): (gp, "gp_nll_and_grads", _train_half),
    ("gp_train_step", "altered"): (gp, "gp_train_step", _train_altered),
    ("gp_predict", "half_batch"): (gp, "gp_predict", _predict_half),
    ("gp_predict", "altered"): (gp, "gp_predict", _predict_altered),
}


#: the faults each entry point can have
FAULTS = {}
for _call, _fault in _PLANTS:
    FAULTS.setdefault(_call, []).append(_fault)


@contextlib.contextmanager
def plant(call, fault):
    module, name, make = _PLANTS[call, fault]
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)
