"""The distributed Level-3 BLAS of the port (cholesky_tpu_torch.parallel:
gemm_dist, syrk_dist, herk_dist, trsm_dist, trmm_dist) at world 4 over
gloo, against the numpy f64/c128 oracle and the JAX package's
cholesky_tpu.parallel.blas on a 4-device CPU mesh.

One world of four spawned ranks for the whole module (``launch.spawn``)
runs every case's rank side (tests/torch_dist_ranks.py, which imports no
JAX). The forms are those of tests/test_parallel_blas.py, on numpy inputs
in f32, f64, c64 and c128, each held against the oracle under
tests/util.assert_close's bound (the JAX tests' flops per element: 2k+3
for a product of depth k, 8k+6 for herk, 30n for a solve, 2n+3 for a
triangular product). The triangular operands carry garbage in their
other triangle, and a unit diagonal's stored value is not 1, so a routine
that reads either fails. One form of each op and one padded case are
also held against the JAX function on the same inputs; every rank's
result is bit-identical, world 1 agrees with world 4, and each call makes
exactly one all_gather (of the output)."""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from cholesky_tpu.parallel import blas as jblas
from cholesky_tpu_torch.parallel import launch
from tests import torch_dist_ranks as ranks
from tests.torch_jcall import jcall
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401
from tests.util import assert_close, to_np128

P = 4
DTYPES = {"f32": np.float32, "f64": np.float64, "c64": np.complex64,
          "c128": np.complex128}
K_GEMM, N_GEMM, K_SYRK, K_HERK, M_TRI = 96, 80, 96, 64, 96


def rnd(seed, shape, dtype=np.float32):
    """Uniform in [-0.5, 0.5) (both planes for a complex dtype)."""
    rng = np.random.default_rng(seed)
    X = rng.random(shape) - 0.5
    if np.iscomplexobj(np.zeros((), dtype)):
        X = X + 1j * (rng.random(shape) - 0.5)
    return X.astype(dtype)


def tri(seed, n, uplo, diag, dtype=np.float32):
    """A triangular operand as tests/test_parallel_blas.py's
    random_triangular makes it (uniform entries, the diagonal pushed one
    away from zero), stored with garbage in the other triangle and, with
    diag U, a stored diagonal of 3."""
    A = rnd(seed, (n, n), dtype)
    d = np.diagonal(A)
    A[np.diag_indices(n)] = d * (np.abs(d) + 1.0) / np.abs(d)
    if diag == "U":
        A[np.diag_indices(n)] = 3.0
    garbage = 100.0 * rnd(seed + 1, (n, n), dtype)
    keep = np.tril(np.ones((n, n), bool)) if uplo == "L" \
        else np.triu(np.ones((n, n), bool))
    return np.where(keep, A, garbage).astype(dtype)


def op(X, trans):
    return X if trans == "N" else (X.T if trans == "T" else X.conj().T)


# --- the cases: (op, args) and the oracle of each --------------------------

def gemm_case(ta, tb, m, dt="f32", seed=0):
    dtype = DTYPES[dt]
    A = rnd(seed, (m, K_GEMM) if ta == "N" else (K_GEMM, m), dtype)
    B = rnd(seed + 1, (K_GEMM, N_GEMM) if tb == "N" else (N_GEMM, K_GEMM),
            dtype)
    C = rnd(seed + 2, (m, N_GEMM), dtype)
    args = (ta, tb, 0.9, A, B, -0.3, C)
    ref = 0.9 * op(to_np128(A), ta) @ op(to_np128(B), tb) - 0.3 * to_np128(C)
    return args, ref, dtype, 2 * K_GEMM + 3


def rank_k_case(kind, uplo, trans, n, dt, seed=6):
    dtype = DTYPES[dt]
    k = K_HERK if kind == "herk" else K_SYRK
    A = rnd(seed, (n, k) if trans == "N" else (k, n), dtype)
    C = rnd(seed + 1, (n, n), dtype)
    alpha, beta = (0.7, -0.2) if kind == "herk" else (-1.0, 1.0)
    X = op(to_np128(A), trans)
    full = alpha * (X @ (X.conj().T if kind == "herk" else X.T)) \
        + beta * to_np128(C)
    if kind == "herk":
        np.fill_diagonal(full, full.diagonal().real)
    mask = (np.tril if uplo == "L" else np.triu)(np.ones((n, n)))
    ref = np.where(mask > 0, full, to_np128(C))
    fpe = 8 * k + 6 if kind == "herk" else 2 * k + 3
    return (uplo, trans, alpha, A, beta, C), ref, dtype, fpe


def tri_ref(A, uplo, diag):
    T = to_np128(A)
    T = np.tril(T) if uplo == "L" else np.triu(T)
    if diag == "U":
        np.fill_diagonal(T, 1.0)
    return T


def trsm_case(side, uplo, trans, diag, n, dt="f32", m=M_TRI, seed=12):
    dtype = DTYPES[dt]
    na = m if side == "L" else n
    A = tri(seed, na, uplo, diag, dtype)
    B = rnd(seed + 2, (m, n), dtype)
    T = op(tri_ref(A, uplo, diag), trans)
    Bn = 0.8 * to_np128(B)
    ref = np.linalg.solve(T, Bn) if side == "L" \
        else np.linalg.solve(T.T, Bn.T).T
    return (side, uplo, trans, diag, 0.8, A, B), ref, dtype, 30 * na


def trmm_case(side, uplo, trans, diag="N", dt="f32", m=200, n=96, seed=8):
    dtype = DTYPES[dt]
    na = m if side == "L" else n
    A = tri(seed, na, uplo, diag, dtype)
    B = rnd(seed + 2, (m, n), dtype)
    T = op(tri_ref(A, uplo, diag), trans)
    ref = 1.3 * (T @ to_np128(B) if side == "L" else to_np128(B) @ T)
    return (side, uplo, trans, diag, 1.3, A, B), ref, dtype, 2 * na + 3


SPECS = {
    **{f"gemm_{ta}{tb}_{m}": ("gemm_dist", gemm_case(ta, tb, m))
       for ta, tb in (("N", "N"), ("T", "N"), ("N", "T")) for m in (256, 200)},
    **{f"gemm_{dt}": ("gemm_dist", gemm_case("N", "T", 200, dt, seed=3))
       for dt in ("f64", "c64", "c128")},
    **{f"syrk_{u}{t}_{n}": ("syrk_dist", rank_k_case("syrk", u, t, n, "f32"))
       for u in "LU" for t in "NT" for n in (200, 201, 333)},
    "syrk_f64": ("syrk_dist", rank_k_case("syrk", "U", "T", 201, "f64")),
    **{f"herk_{u}{t}_{n}": ("herk_dist", rank_k_case("herk", u, t, n, "c64"))
       for u in "LU" for t in "NC" for n in (200, 201)},
    "herk_c128": ("herk_dist", rank_k_case("herk", "L", "C", 201, "c128")),
    **{f"trsm_{s}{u}{t}{d}_{n}": ("trsm_dist", trsm_case(s, u, t, d, n))
       for s in "LR" for u in "LU" for t in "NT" for d in "NU"
       for n in (200, 333)},
    **{f"trsm_{dt}": ("trsm_dist", trsm_case("L", "L", "N", "N", 64, dt,
                                             m=160))
       for dt in ("f64", "c64", "c128")},
    "trsm_c64_RUCU": ("trsm_dist", trsm_case("R", "U", "C", "U", 201, "c64",
                                             m=66)),
    **{f"trmm_{s}{u}{t}": ("trmm_dist", trmm_case(s, u, t))
       for s in "LR" for u in "LU" for t in "NT"},
    "trmm_LLNU": ("trmm_dist", trmm_case("L", "L", "N", "U")),
    **{f"trmm_{dt}": ("trmm_dist", trmm_case("L", "L", "N", "N", dt, m=160,
                                             n=64))
       for dt in ("f64", "c64", "c128")},
    "trmm_c128_RLCN": ("trmm_dist", trmm_case("R", "L", "C", "N", "c128",
                                              m=66, n=201)),
}
CASES = {name: ("blas", dict(op=fn, args=spec[0]))
         for name, (fn, spec) in SPECS.items()}
#: the forms also held against the JAX function: one of each op, and two
#: padded ones (syrk at n = 201, whose rows pad to 204, where JAX pads
#: both dimensions of C; the left trsm at n = 333, whose columns pad to
#: 336)
JAX_FORMS = ("gemm_NN_256", "syrk_LN_200", "syrk_LN_201", "herk_LN_200",
             "trsm_LLNN_200", "trsm_LUTU_333", "trmm_LLN")


@pytest.fixture(scope="module")
def world():
    """Every case on every rank of one world of P gloo ranks."""
    # 20-23 s in the suite under six workers
    return launch.spawn(P, ranks.run, CASES, timeout=90.0)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:P]), ("d",))


def got(world, name, rank=0):
    return world[rank][name]["out"]


@pytest.mark.parametrize("name", list(SPECS))
def test_dist_blas_vs_numpy_oracle(world, name):
    _, (args, ref, dtype, fpe) = SPECS[name]
    out = got(world, name)
    assert out.dtype == dtype
    assert_close(out, ref, dtype, fpe, name)


@pytest.mark.parametrize("name", [n for n in SPECS
                                  if n.startswith(("syrk", "herk"))])
def test_rank_k_keeps_the_other_triangle(world, name):
    (uplo, _, _, _, _, C), _, _, _ = SPECS[name][1]
    out = got(world, name)
    other = np.triu if uplo == "L" else np.tril
    np.testing.assert_array_equal(other(out, 1 if uplo == "L" else -1),
                                  other(C, 1 if uplo == "L" else -1))
    if name.startswith("herk"):
        assert not np.diagonal(out).imag.any()


@functools.lru_cache(maxsize=None)
def jax_result(name, mesh):
    fn, (args, _, _, _) = SPECS[name]
    return np.asarray(jcall(getattr(jblas, fn), *args, mesh))


@pytest.mark.parametrize("name", JAX_FORMS)
def test_dist_blas_vs_jax(world, mesh, name):
    _, (_, _, dtype, fpe) = SPECS[name]
    assert_close(got(world, name), jax_result(name, mesh), dtype, fpe,
                 f"{name} vs JAX")


@pytest.mark.parametrize("name", list(SPECS))
def test_result_identical_on_every_rank(world, name):
    out = got(world, name)
    for r in range(1, P):
        assert got(world, name, r).tobytes() == out.tobytes(), \
            f"{name} differs between rank 0 and rank {r}"


@pytest.mark.parametrize("name", list(SPECS))
def test_census_one_all_gather_per_call(world, name):
    for r in range(P):
        assert world[r][name]["counts"] == {
            "broadcast": 0, "all_reduce": 0, "all_gather": 1}


@pytest.mark.parametrize("name", ["gemm_TN_200", "syrk_UT_333",
                                  "herk_UC_201", "trsm_RLNU_333",
                                  "trmm_RUT", "trmm_c128_RLCN"])
def test_world_of_one_matches_world_four(world, name):
    # no process group in this process: group=None is a world of one
    one = ranks.run(0, {name: CASES[name]})[name]
    assert one["counts"]["all_gather"] == 1
    _, (_, _, dtype, fpe) = SPECS[name]
    assert_close(one["out"], got(world, name), dtype, fpe,
                 f"{name}: world 1 vs world 4")
