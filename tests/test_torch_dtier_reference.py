"""The d tier against the benchmark's plain reference: the port's dpotrf
then dpotri with backend="ozaki" (on the CPU the kernel wrappers run their
twins), on the benchmark's seeded dense SPD inputs, against
``benchmark/reference`` in float64 (the blocked Cholesky of
``lapack.potrf_lower`` and the inverse of ``potri.potri_lower``), in both
variants of the recursion. The reference imports nothing of the program.

Bounds: those of tests/test_torch_dtier.py, the JAX package's own for
the d tier: 1e-9 relative for a factor and 1e-8 for an inverse (the
Ozaki products keep about 2^-42 of each product, and the inverse carries
the factor's error times the condition number, 100 here). The control,
the reference in float32, must fail the inverse bound: a d tier that
computed in float32 would."""

import pytest
import torch

import cholesky_tpu_torch as ct
from benchmark import compare, inputs
from benchmark.reference.lapack import potrf_lower
from benchmark.reference.potri import potri_lower
from cholesky_tpu_torch.ops import blocked

FACTOR_BOUND = 1e-9
INVERSE_BOUND = 1e-8
SEED = 2 ** 31 + 20


def dense_spd(n):
    return inputs.dense_spd(inputs.generator(SEED, "cpu"), n, 100.0,
                            torch.float64, "cpu")


@pytest.mark.parametrize("hoist", [True, False], ids=["hoist", "prehoist"])
@pytest.mark.parametrize("n, block_size", [(256, 64), (200, None)],
                         ids=["n256-nb64", "n200-ragged"])
def test_dpotrf_dpotri_against_the_reference(n, block_size, hoist,
                                             monkeypatch):
    monkeypatch.setattr(blocked, "_OZAKI_HOIST_OVERRIDE", hoist)
    A = dense_spd(n)
    F, i1 = ct.dpotrf("L", A, backend="ozaki", block_size=block_size)
    inv, i2 = ct.dpotri("L", F, backend="ozaki", block_size=block_size)
    assert int(i1) == int(i2) == 0
    L, info = potrf_lower(A, "f64")
    assert info == 0
    assert compare.tril_rel_err(F, L) < FACTOR_BOUND
    assert compare.tril_rel_err(inv, potri_lower(L, "f64")) < INVERSE_BOUND
    # the opposite strict triangle is the caller's
    assert torch.equal(torch.triu(inv, 1), torch.triu(A, 1))


def test_the_float32_control_fails_the_inverse_bound():
    A = dense_spd(256)
    L, _ = potrf_lower(A, "f64")
    ref = potri_lower(L, "f64")
    L32 = torch.linalg.cholesky(A.float())
    assert compare.tril_rel_err(potri_lower(L32, "f32"), ref) \
        > 10 * INVERSE_BOUND
