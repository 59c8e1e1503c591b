"""The public gemm, gemm2, syrk, herk and potf2 of cholesky_tpu_torch and
their typed s/d wrappers, against the JAX package's blocked routines on the
same numpy inputs: backend="xla" for the BLAS, and for potf2 its default
"auto" (the Pallas leaf or whole-block kernel, in interpret mode).

Each case runs the port's CPU routes: the torch tile (the CPU's default),
the card's kernel route (``_KernelTiles``, whose wrappers run their twins
on the CPU) for f32, and the Ozaki tile for f64. Bounds: tests/util.py's
2k+3 for a product of depth k and 8n for a Cholesky factor; 1e-9 relative
for the Ozaki products, as tests/test_torch_dtier.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu_torch.ops import blocked as tblocked
from cholesky_tpu_torch.ops import kernels
from tests.util import assert_close

F32, F64 = np.float32, np.float64


def rnd(shape, seed, dtype=F32):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(dtype)


def spd_np(n, cond=50.0, seed=0, dtype=F32):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return (0.5 * (A + A.T)).astype(dtype)


ROUTES = {"f32 torch": (F32, None), "f32 kernel": (F32, "kernel"),
          "f64 torch": (F64, None), "f64 ozaki": (F64, "ozaki")}


def use_route(route, monkeypatch):
    """The dtype of a route; sends a CPU tensor down the kernel route (the
    card's f32 one) or names the Ozaki backend."""
    dtype, tiles = ROUTES[route]
    if tiles == "kernel":
        real = tblocked._tiles_for
        monkeypatch.setattr(tblocked, "_tiles_for", lambda A, *a, **k: (
            tblocked._KernelTiles() if A.dtype == torch.float32
            else real(A, *a, **k)))
    return dtype, ("ozaki" if tiles == "ozaki" else "auto")


def close(got, ref, dtype, fpe, what):
    if dtype == F64:        # the Ozaki products: 1e-9 relative
        ref = np.asarray(ref)
        err = np.max(np.abs(got - ref))
        assert err <= 1e-9 * np.max(np.abs(ref)), f"{what}: {err:.3e}"
    else:
        assert_close(got, ref, dtype, fpe, what)


# ---------------------------------------------------------------------------
# gemm, gemm2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("transa", ["N", "T"])
@pytest.mark.parametrize("transb", ["N", "T"])
@pytest.mark.parametrize("beta", [0.0, -0.4])
def test_gemm_vs_jax(route, transa, transb, beta, monkeypatch):
    dtype, backend = use_route(route, monkeypatch)
    m, n, k = 70, 50, 90
    A = rnd((m, k) if transa == "N" else (k, m), 1, dtype)
    B = rnd((k, n) if transb == "N" else (n, k), 2, dtype)
    C = rnd((m, n), 3, dtype)
    Ct = torch.from_numpy(C.copy())
    got = ct.gemm(transa, transb, 0.9, torch.from_numpy(A),
                  torch.from_numpy(B), beta, Ct, backend=backend)
    ref = jblocked.gemm(transa, transb, 0.9, jnp.asarray(A), jnp.asarray(B),
                        beta, jnp.asarray(C), backend="xla")
    close(got.numpy(), ref, dtype, 2 * k + 3, f"gemm {transa}{transb}")
    np.testing.assert_array_equal(Ct.numpy(), C)        # C is not modified
    g2 = tblocked.gemm2(transa, transb, 0.9, torch.from_numpy(A),
                        torch.from_numpy(B), beta, Ct, backend=backend)
    torch.testing.assert_close(g2, got, rtol=0, atol=0)


def test_gemm_checks_shapes():
    with pytest.raises(ValueError):
        ct.gemm("N", "N", 1.0, torch.zeros(3, 4), torch.zeros(5, 2), 0.0,
                torch.zeros(3, 2))
    with pytest.raises(ValueError):
        ct.gemm("N", "T", 1.0, torch.zeros(3, 4), torch.zeros(2, 4), 0.0,
                torch.zeros(3, 3))


# ---------------------------------------------------------------------------
# syrk, herk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_syrk_vs_jax(route, uplo, trans, beta, monkeypatch):
    dtype, backend = use_route(route, monkeypatch)
    n, k = 96, 130
    A = rnd((n, k) if trans == "N" else (k, n), 4, dtype)
    C = rnd((n, n), 5, dtype)
    got = ct.syrk(uplo, trans, -1.2, torch.from_numpy(A), beta,
                  torch.from_numpy(C.copy()), backend=backend).numpy()
    ref = np.asarray(jblocked.syrk(uplo, trans, -1.2, jnp.asarray(A), beta,
                                   jnp.asarray(C), backend="xla"))
    tri = np.tril if uplo == "L" else np.triu
    close(tri(got), tri(ref), dtype, 2 * k + 3, f"syrk {uplo}{trans}")
    # the other strict triangle is C's, bit for bit
    other = np.triu if uplo == "L" else np.tril
    kk = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(got, kk), other(C, kk))


@pytest.mark.parametrize("route", ["f32 torch", "f32 kernel", "f64 torch"])
@pytest.mark.parametrize("uplo,trans", [("L", "N"), ("U", "C")])
def test_herk_vs_jax(route, uplo, trans, monkeypatch):
    # real operands: f32 is syrk, f64 the oracle, as in JAX
    dtype, backend = use_route(route, monkeypatch)
    A = rnd((64, 80) if trans == "N" else (80, 64), 6, dtype)
    C = rnd((64, 64), 7, dtype)
    got = ct.herk(uplo, trans, 0.5, torch.from_numpy(A), 2.0,
                  torch.from_numpy(C), backend=backend).numpy()
    ref = jblocked.herk(uplo, trans, 0.5, jnp.asarray(A), 2.0,
                        jnp.asarray(C), backend="xla")
    assert_close(got, np.asarray(ref), dtype, 2 * 80 + 3, f"herk {uplo}")


def test_syrk_on_the_kernel_route_calls_the_syrk_kernel(monkeypatch):
    # upper goes through the transposed view of the result, never gemm
    use_route("f32 kernel", monkeypatch)
    seen = []
    real = tblocked._KernelTiles.syrk_ln
    monkeypatch.setattr(tblocked._KernelTiles, "syrk_ln", staticmethod(
        lambda alpha, A, beta, C: seen.append(C.stride()) or real(
            alpha, A, beta, C)))
    C = torch.from_numpy(rnd((32, 32), 8))
    ct.syrk("U", "N", 1.0, torch.from_numpy(rnd((32, 16), 9)), 1.0, C)
    ct.syrk("L", "N", 1.0, torch.from_numpy(rnd((32, 16), 9)), 1.0, C)
    assert seen == [(1, 32), (32, 1)]


# ---------------------------------------------------------------------------
# potf2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["f32 torch", "f32 kernel", "f64 torch"])
@pytest.mark.parametrize("n,uplo", [(8, "L"), (128, "U"), (256, "L")])
def test_potf2_vs_jax(route, n, uplo, monkeypatch):
    dtype, backend = use_route(route, monkeypatch)
    A = spd_np(n, dtype=dtype)
    got, info = ct.potf2(uplo, torch.from_numpy(A), backend=backend)
    ref, info_j = jblocked.potf2(uplo, jnp.asarray(A))
    assert int(info) == int(info_j) == 0
    assert_close(got.numpy(), np.asarray(ref), dtype, 8 * n,
                 f"potf2 n={n} {uplo}")


@pytest.mark.parametrize("route", ["f32 torch", "f32 kernel"])
def test_potf2_nonpd_vs_jax(route, monkeypatch):
    _, backend = use_route(route, monkeypatch)
    A = spd_np(256, cond=10.0)
    A[150, 150] = -1.0
    got, info = ct.potf2("L", torch.from_numpy(A), backend=backend)
    ref, info_j = jblocked.potf2("L", jnp.asarray(A))
    assert int(info) == int(info_j) == 151
    assert_close(np.tril(got.numpy())[:150, :150],
                 np.tril(np.asarray(ref))[:150, :150], F32, 8 * 256,
                 "potf2 nonpd leading block")


def test_potf2_kernel_route_above_the_whole_block_cap(monkeypatch):
    # a block the whole-matrix kernels refuse reaches potf2_f32 (here its
    # twin): the route of spotf2 above the potrf_stream_f32 cap
    use_route("f32 kernel", monkeypatch)
    monkeypatch.setattr(tblocked, "_mega_ok", lambda n, op="potrf": False)
    seen = []
    real = kernels.potf2_f32
    monkeypatch.setattr(tblocked._k, "potf2_f32",
                        lambda A: seen.append(A.shape) or real(A))
    A = spd_np(384)
    got, info = ct.spotf2("U", torch.from_numpy(A))
    ref, info_j = jblocked.potf2("U", jnp.asarray(A))
    assert int(info) == int(info_j) == 0 and seen == [(384, 384)]
    assert_close(got.numpy(), np.asarray(ref), F32, 8 * 384, "potf2 leaf")


# ---------------------------------------------------------------------------
# typed wrappers, complex operands, the oracle for traced scalars
# ---------------------------------------------------------------------------

TYPED = {
    "gemm": lambda X: ("N", "N", 1.0, X, X, 0.0, X),
    "syrk": lambda X: ("L", "N", 1.0, X, 0.0, X),
    "trmm": lambda X: ("L", "L", "N", "N", 1.0, X, X),
    "trmm2": lambda X: ("L", "L", "N", "N", 1.0, X, X),
    "potf2": lambda X: ("L", X),
}
MATRIX_ARG = {"gemm": 4, "syrk": 4, "trmm": 6, "trmm2": 6, "potf2": 2}


@pytest.mark.parametrize("letter", ["s", "d"])
@pytest.mark.parametrize("name", sorted(TYPED))
def test_typed_wrappers(letter, name):
    # the right dtype runs; the other is refused at the matrix argument
    dtype = torch.float32 if letter == "s" else torch.float64
    other = torch.float64 if letter == "s" else torch.float32
    fn = getattr(ct, letter + name)
    fn(*TYPED[name](torch.eye(4, dtype=dtype) * 2.0))
    seen = []
    prev = ct.set_xerbla(lambda routine, arg, msg="": seen.append(
        (routine, arg)))
    try:
        with pytest.raises(ValueError, match="expected"):
            fn(*TYPED[name](torch.eye(4, dtype=other)))
    finally:
        ct.set_xerbla(prev)
    assert seen == [(letter + name, MATRIX_ARG[name])]


def test_no_typed_herk_or_gemm2():
    # as in the JAX package: herk is typed only for c/z, gemm2 not at all
    for name in ("sherk", "dherk", "sgemm2", "dgemm2", "gemm2"):
        assert not hasattr(ct, name)


@pytest.mark.parametrize("name", ["gemm", "syrk", "herk", "trmm", "potf2"])
def test_complex_is_not_ported_yet(name):
    # the c/z tier is ported now: a complex CPU tensor runs under 'auto'
    # (the oracle for the BLAS, the native torch tile for potf2, as JAX
    # off its accelerator) and under 'embed' (the real embedding), both
    # as backend='ref' computes it (tests/test_torch_complex.py holds the
    # c/z tier against the JAX package)
    X = torch.eye(4, dtype=torch.complex64) * (2.0 + 0.5j)
    X[2, 1] = 0.25 - 0.125j
    if name == "potf2":
        X = X @ X.mH
    args = {"herk": ("L", "N", 1.0, X, 0.0, X), **{
        k: f(X) for k, f in TYPED.items()}}[name]
    ref = getattr(ct, name)(*args, backend="ref")
    backends = ["auto"] if name == "syrk" else ["auto", "embed"]
    for backend in backends:
        got = getattr(ct, name)(*args, backend=backend)
        if name == "potf2":
            (got, info), ref_f = got, ref[0]
            assert int(info) == 0
        else:
            ref_f = ref
        assert got.dtype == torch.complex64
        torch.testing.assert_close(got, ref_f, rtol=0, atol=1e-6)


def test_a_tensor_alpha_takes_the_oracle():
    # on the CPU a scalar that is not a Python number goes to blas_ref, as
    # JAX sends a traced one (blocked.py:953-954); on the card it is read
    # with float() and the kernel runs (test_torch_cuda.py)
    A, B, C = (torch.from_numpy(rnd((8, 8), s)) for s in (10, 11, 12))
    a = torch.tensor(0.5)
    assert torch.equal(ct.gemm("N", "T", a, A, B, 1.0, C),
                       ct.gemm("N", "T", 0.5, A, B, 1.0, C, backend="ref"))
    assert torch.equal(ct.trmm("R", "U", "N", "U", a, A, B),
                       ct.trmm("R", "U", "N", "U", 0.5, A, B, backend="ref"))
