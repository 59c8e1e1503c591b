"""The c/z tier of cholesky_tpu_torch on the CPU: the interleaved real
embedding (ops/complex_embed.py) under backend="embed", the native torch
tile under backend="torch" (what "auto" runs for a complex CPU tensor),
the (re, im) pair form, the routing and the oracle tier in c/z, each held
against the JAX package on the same numpy inputs: its
``complex_embed.*_split(backend="xla")``, its blocked drivers under
"xla", and its lapack_ref/blas_ref.

On the card "auto" sends a complex tensor through the embedding onto the
CUDA kernels; tests/test_torch_cuda.py holds that route there.

Tolerances are tests/util.py's eps-scaled bounds, with the JAX package's
own flops-per-element factors for these routines (tests/
test_complex_embed.py): 16n for a factor (the embedding works at 2n), 80n
for a triangular inverse or a logdet, 4000n for potri, 150n for a solve,
2k+3 for a product of depth k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu.ops import blas_ref as jblas
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu.ops import complex_embed as jce
from cholesky_tpu.ops import lapack_ref as jlapack
from cholesky_tpu_torch.ops import blas_ref, blocked, lapack_ref
from cholesky_tpu_torch.ops import complex_embed as ce
from tests.util import assert_close

N, NB = 96, 32
# every side/uplo/trans/diag form: 24 with the conjugate transpose
FORMS = [(s, u, t, d) for s in "LR" for u in "LU" for t in "NTC"
         for d in "NU"]


def crand_np(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def hpd_np(n, dtype, cond=40.0, seed=0):
    Q, _ = np.linalg.qr(crand_np((n, n), np.complex128, seed))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.conj().T
    A = 0.5 * (A + A.conj().T)
    np.fill_diagonal(A, A.diagonal().real)
    return A.astype(dtype)


def tri_np(n, uplo, dtype, seed):
    """A well-conditioned triangle with a complex diagonal, garbage in the
    other strict triangle (it must never be read)."""
    T = crand_np((n, n), np.complex128, seed) / np.sqrt(n)
    np.fill_diagonal(T, (1.5 + np.random.default_rng(seed).uniform(
        0, 1, n)) * np.exp(1j * np.linspace(0.0, 3.0, n)))
    return T.astype(dtype)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def pair(x):
    return t(x.real.copy()), t(x.imag.copy())


def to_np(x):
    if isinstance(x, tuple):
        return x[0].numpy() + 1j * x[1].numpy()
    return x.numpy()


def jx(x):
    return jnp.asarray(x)


def jcall(fn, *args, **kw):
    """fn(*args, **kw) of the JAX package, jitted over its array
    arguments: an eager call traces every leaf's loop anew."""
    idx = [i for i, a in enumerate(args) if hasattr(a, "shape")]

    def f(*arrays):
        full = list(args)
        for i, a in zip(idx, arrays):
            full[i] = a
        return fn(*full, **kw)

    return jax.jit(f)(*(jnp.asarray(args[i]) for i in idx))


# ---------------------------------------------------------------------------
# the embedding and the routing
# ---------------------------------------------------------------------------

def test_embed_matches_jax_and_is_a_homomorphism():
    A, B = crand_np((6, 5), np.complex128, 1), crand_np((5, 3),
                                                         np.complex128, 2)
    M = ce.embed(*pair(A))
    np.testing.assert_array_equal(
        M.numpy(), np.asarray(jce.embed(jx(A.real), jx(A.imag))))
    re, im = ce.unembed(M)
    np.testing.assert_array_equal(re.numpy(), A.real)
    np.testing.assert_array_equal(im.numpy(), A.imag)
    EA, EB = M.numpy(), ce.embed(*pair(B)).numpy()
    np.testing.assert_allclose(EA @ EB, ce.embed(*pair(A @ B)).numpy(),
                               atol=1e-13)


def test_route_complex_policy():
    re = torch.zeros(4, 4, dtype=torch.float64)
    z = torch.zeros(4, 4, dtype=torch.complex64)
    assert blocked._route_complex((re, re), "auto")
    assert blocked._route_complex((re, re), "torch")
    assert blocked._route_complex(z, "embed")
    assert not blocked._route_complex(z, "auto")    # a CPU tensor: native
    assert not blocked._route_complex(z, "torch")
    assert not blocked._route_complex(re, "auto")
    assert not blocked._route_complex(re, "embed")
    assert blocked._embed_backend("embed") == "auto"
    assert blocked._embed_backend("ozaki") == "ozaki"
    with pytest.raises(ValueError):
        ct.potrf("L", torch.eye(8), backend="embed")   # needs complex
    with pytest.raises(ValueError):
        ct.gemm("N", "N", 1.0, torch.eye(8), torch.eye(8), 0.0,
                torch.eye(8), backend="embed")
    with pytest.raises(ValueError):
        ct.potrf("L", z, backend="xla")                # not a port backend


def test_real_diag_form_matches_jax():
    L = np.tril(tri_np(12, "L", np.complex128, 3))
    L[4, 4] = 0.0                                       # |d| = 0 is kept
    got = ce._real_diag_form(*pair(L))
    want = jce._real_diag_form(jx(L.real), jx(L.imag))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the real-diagonal form embeds to a lower-triangular matrix, up to
    # the rounding of d·conj(d)/|d|'s imaginary part
    E = ce.embed(got[0], got[1]).numpy()
    assert np.abs(np.triu(E, 1)).max() <= 4 * np.finfo(np.float64).eps


# ---------------------------------------------------------------------------
# the drivers: the port's 'embed' against JAX's *_split, its 'torch'
# against JAX's blocked drivers under 'xla'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,uplo,backend", [
    (np.complex64, "L", "embed"), (np.complex128, "U", "embed"),
    (np.complex128, "L", "torch"), (np.complex64, "U", "torch")])
def test_potrf_vs_jax(dtype, uplo, backend):
    # 'embed' against JAX's potrf_split, 'torch' against its native blocked
    # potrf under 'xla'
    A = hpd_np(N, dtype)
    A[np.triu_indices(N, 1) if uplo == "L" else np.tril_indices(N, -1)] = \
        crand_np(N * (N - 1) // 2, dtype, 9)           # the other triangle
    jfn = jce.potrf_split if backend == "embed" else jblocked.potrf
    Fj, info_j = jcall(jfn, uplo, A, backend="xla", block_size=NB)
    F, info = ct.potrf(uplo, t(A), backend=backend, block_size=NB)
    assert F.dtype == t(A).dtype
    assert int(info) == int(info_j) == 0
    assert_close(F.numpy(), np.asarray(Fj), dtype, 16 * N,
                 f"potrf {uplo} {backend}")
    other = np.triu if uplo == "L" else np.tril
    k = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(F.numpy(), k), other(A, k))


def test_pair_form():
    A = hpd_np(N, np.complex128, seed=2)
    (fr, fi), info = ct.zpotrf("L", pair(A), block_size=NB)   # auto: embed
    F, info_t = ct.potrf("L", t(A), backend="embed", block_size=NB)
    assert int(info) == int(info_t) == 0
    assert fr.dtype == torch.float64
    np.testing.assert_array_equal(fr.numpy() + 1j * fi.numpy(), F.numpy())
    val, _ = ct.zlogdet("L", pair(A), block_size=NB)
    _, ref = np.linalg.slogdet(A)
    assert_close(float(val), ref, np.complex128, 80 * N, "pair logdet")
    with pytest.raises(ValueError):
        ct.cpotrf("L", pair(A))                # c takes float32 planes
    with pytest.raises(ValueError):
        ct.zpotrf("L", t(A.astype(np.complex64)))


def test_nonpd_info():
    A = hpd_np(N, np.complex64, seed=3)
    A[50, 50] = -3.0
    _, info_j = jcall(jce.potrf_split, "L", A, backend="xla", block_size=NB)
    for backend in ("embed", "torch"):
        F, info = ct.potrf("L", t(A), backend=backend, block_size=NB)
        assert int(info) == int(info_j) == 51, backend   # the complex pivot
        lead = np.tril(F.numpy()[:50, :50])
        assert_close(lead @ lead.conj().T, A[:50, :50], np.complex64,
                     16 * N, f"nonpd leading block {backend}")


def test_potri_logdet_vs_jax_split():
    A = hpd_np(N, np.complex128, cond=20.0, seed=5)
    Fj, _ = jcall(jce.potrf_split, "L", A, backend="xla", block_size=NB)
    F = t(np.array(Fj))
    inv_j, info_j = jcall(jce.potri_split, "L", Fj, backend="xla",
                          block_size=NB)
    inv, info = ct.potri("L", F, backend="embed", block_size=NB)
    assert int(info) == int(info_j) == 0
    assert_close(np.tril(inv.numpy()), np.tril(np.asarray(inv_j)),
                 np.complex128, 4000 * N, "potri embed")
    val_j, _ = jcall(jce.logdet_split, "L", A, backend="xla", block_size=NB)
    val, info = ct.logdet("L", t(A), backend="embed", block_size=NB)
    assert int(info) == 0
    assert_close(float(val), float(val_j), np.complex128, 80 * N, "logdet")


def test_potri_torch_tile_vs_jax_xla():
    A = hpd_np(N, np.complex64, cond=20.0, seed=6)
    F, _ = ct.potrf("U", t(A), backend="torch", block_size=NB)
    inv_j, info_j = jcall(jblocked.potri, "U", F.numpy(), backend="xla",
                          block_size=NB)
    inv, info = ct.potri("U", F, backend="torch", block_size=NB)
    assert int(info) == int(info_j) == 0
    assert_close(np.triu(inv.numpy()), np.triu(np.asarray(inv_j)),
                 np.complex64, 4000 * N, "potri torch")
    np.testing.assert_array_equal(np.tril(inv.numpy(), -1),
                                  np.tril(F.numpy(), -1))


@pytest.mark.parametrize("diag", ["N", "U"])
def test_trtri_and_lauum_vs_jax_split(diag):
    T = tri_np(N, "U", np.complex64, 7)
    if diag == "U":
        # the JAX package reads a unit triangle's stored imaginary diagonal
        # (ROADMAP Queue 3); JAX's own tests store 1 there
        np.fill_diagonal(T, 1.0)
    W_j, info_j = jcall(jce.trtri_split, "U", diag, T, backend="xla",
                        block_size=NB)
    W, info = ct.ctrtri("U", diag, t(T), backend="embed", block_size=NB)
    assert int(info) == int(info_j) == 0
    assert_close(np.triu(W.numpy()), np.triu(np.asarray(W_j)), np.complex64,
                 80 * N, f"trtri {diag}")
    np.testing.assert_array_equal(np.tril(W.numpy(), -1), np.tril(T, -1))
    if diag == "N":
        R_j = jcall(jce.lauum_split, "U", T, backend="xla", block_size=NB)
        R = ct.clauum("U", t(T), backend="embed", block_size=NB)
        assert_close(np.triu(R.numpy()), np.triu(np.asarray(R_j)),
                     np.complex64, 2 * N + 3, "lauum")


def test_unit_diagonal_is_not_referenced():
    # diag='U': the stored diagonal, complex here, is never read, and
    # trtri passes it through, as LAPACK's
    T = tri_np(64, "L", np.complex128, 27)
    U1 = np.tril(T, -1) + np.eye(64)
    W, info = ct.trtri("L", "U", pair(T), block_size=16)
    want = np.linalg.inv(U1)
    np.fill_diagonal(want, np.diagonal(T))
    assert int(info) == 0
    assert_close(np.tril(to_np(W)), want, np.complex128, 80 * 64,
                 "unit trtri")
    B = crand_np((64, 5), np.complex128, 28)
    X = ct.trsm("L", "L", "T", "U", 1.0, pair(T), pair(B), block_size=16)
    assert_close(to_np(X), np.linalg.solve(U1.T, B), np.complex128,
                 150 * 64, "unit trsm")

# ---------------------------------------------------------------------------
# the BLAS: every trsm/trmm form with a complex alpha
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side,uplo,trans,diag", FORMS)
def test_trsm_all_forms(side, uplo, trans, diag):
    na, k = 48, 20
    A = tri_np(na, uplo, np.complex128, 8)
    B = crand_np((na, k) if side == "L" else (k, na), np.complex128, 9)
    alpha = 0.75 - 0.5j
    want = np.asarray(jblas.trsm(side, uplo, trans, diag, alpha, jx(A),
                                 jx(B)))
    X = ct.trsm(side, uplo, trans, diag, alpha, pair(A), pair(B),
                block_size=16)                          # a pair: embedded
    assert_close(to_np(X), want, np.complex128, 150 * na,
                 f"trsm {side}{uplo}{trans}{diag} pair")
    Xc = ct.trsm(side, uplo, trans, diag, alpha, t(A.astype(np.complex64)),
                 t(B.astype(np.complex64)), backend="embed", block_size=16)
    assert Xc.dtype == torch.complex64
    assert_close(Xc.numpy(), want.astype(np.complex64), np.complex64,
                 150 * na, f"trsm {side}{uplo}{trans}{diag} c64")
    # a complex tensor the embedding does not take goes to the oracle
    Xo = ct.trsm(side, uplo, trans, diag, alpha, t(A), t(B))
    assert_close(Xo.numpy(), want, np.complex128, 150 * na, "trsm oracle")


@pytest.mark.parametrize("side,uplo,trans", [
    ("L", "L", "N"), ("R", "U", "C")])
def test_trsm_vs_jax_split(side, uplo, trans):
    A = tri_np(N, uplo, np.complex64, 10)
    B = crand_np((N, 8) if side == "L" else (8, N), np.complex64, 11)
    want = jcall(jce.trsm_split, side, uplo, trans, "N", 0.9j, A, B,
                 backend="xla", block_size=NB)
    X = ct.ctrsm(side, uplo, trans, "N", 0.9j, t(A), t(B), backend="embed",
                 block_size=NB)
    assert_close(X.numpy(), np.asarray(want), np.complex64, 150 * N,
                 f"trsm {side}{uplo}{trans}")


@pytest.mark.parametrize("side,uplo,trans,diag", FORMS)
def test_trmm_all_forms(side, uplo, trans, diag):
    na, k = 40, 12
    A = tri_np(na, uplo, np.complex64, 12)
    B = crand_np((na, k) if side == "L" else (k, na), np.complex64, 13)
    alpha = -1.25 + 0.5j
    want = jce.trmm_split(side, uplo, trans, diag, alpha, jx(A), jx(B),
                          backend="xla")
    got = ct.trmm(side, uplo, trans, diag, alpha, t(A), t(B),
                  backend="embed")
    assert_close(got.numpy(), np.asarray(want), np.complex64, 2 * na + 3,
                 f"trmm {side}{uplo}{trans}{diag}")
    ref = ct.trmm(side, uplo, trans, diag, alpha, t(A), t(B))   # oracle
    assert_close(ref.numpy(), np.asarray(want), np.complex64, 2 * na + 3,
                 "trmm oracle")


def test_trmm_live_block_recursion():
    # above the 512 leaf, the live-block recursion over embedded gemms
    n = 1100
    A = tri_np(n, "L", np.complex128, 14)
    B = crand_np((n, 3), np.complex128, 15)
    got = ct.ztrmm("L", "L", "N", "N", 2.0, pair(A), pair(B))
    assert_close(to_np(got), 2.0 * np.tril(A) @ B, np.complex128,
                 2 * n + 3, "trmm recursion")


@pytest.mark.parametrize("transa,transb,alpha,beta", [
    ("N", "N", 1.5, -0.5), ("C", "T", 0.5 + 1j, 2.0 - 0.5j),
    ("T", "C", 1j, 0.0)])
def test_gemm_vs_jax(transa, transb, alpha, beta):
    A, B, C = (crand_np((N, N), np.complex64, s) for s in (16, 17, 18))
    want = jce.gemm_split(transa, transb, alpha, jx(A), jx(B), beta, jx(C),
                          backend="xla")
    got = ct.gemm(transa, transb, alpha, t(A), t(B), beta, t(C),
                  backend="embed")
    assert_close(got.numpy(), np.asarray(want), np.complex64, 2 * N + 3,
                 "gemm embed")
    want_o = jblas.gemm(transa, transb, alpha, jx(A), jx(B), beta, jx(C))
    got_o = ct.cgemm(transa, transb, alpha, t(A), t(B), beta, t(C))
    assert_close(got_o.numpy(), np.asarray(want_o), np.complex64, 2 * N + 3,
                 "gemm oracle")


@pytest.mark.parametrize("uplo,trans", [("L", "N"), ("U", "C")])
def test_herk_vs_jax(uplo, trans):
    A = crand_np((N, 40) if trans == "N" else (40, N), np.complex128, 19)
    C = crand_np((N, N), np.complex128, 20)            # a complex diagonal
    want = jce.herk_split(uplo, trans, 0.5, jx(A), -1.0, jx(C),
                          backend="xla")
    got = ct.zherk(uplo, trans, 0.5, pair(A), -1.0, pair(C))
    assert_close(to_np(got), np.asarray(want), np.complex128, 2 * 40 + 3,
                 "herk embed")
    assert torch.all(got[1].diagonal() == 0)           # exactly real
    k = 1 if uplo == "L" else -1
    other = np.triu if uplo == "L" else np.tril
    np.testing.assert_array_equal(other(to_np(got), k), other(C, k))
    want_o = jblas.herk(uplo, trans, 0.5, jx(A), -1.0, jx(C))
    got_o = ct.herk(uplo, trans, 0.5, t(A), -1.0, t(C))
    assert_close(got_o.numpy(), np.asarray(want_o), np.complex128,
                 2 * 40 + 3, "herk oracle")
    assert np.all(np.diagonal(got_o.numpy()).imag == 0)


def test_syrk_is_not_herk():
    A = crand_np((12, 5), np.complex64, 21)
    C = crand_np((12, 12), np.complex64, 22)
    with pytest.raises(ValueError):
        ct.syrk("L", "N", 1.0, pair(A), 0.0, pair(C))  # no pair syrk
    with pytest.raises(ValueError):
        blas_ref.syrk("L", "C", 1.0, t(A), 0.0, t(C))  # 'C' is herk
    with pytest.raises(ValueError):
        blas_ref.herk("L", "T", 1.0, t(A), 0.0, t(C))  # 'T' is syrk
    want = jblas.syrk("U", "N", 2.0, jx(A), 0.5, jx(C))
    assert_close(ct.syrk("U", "N", 2.0, t(A), 0.5, t(C)).numpy(),
                 np.asarray(want), np.complex64, 2 * 5 + 3, "complex syrk")


def test_scalars_the_embedding_may_read():
    A, B, C = (crand_np((8, 8), np.complex128, s) for s in (23, 24, 25))
    a = torch.tensor(0.5)
    # a pair needs a Python number off the card, as JAX needs a static one
    with pytest.raises(ValueError):
        ct.gemm("N", "N", a, pair(A), pair(B), 1.0, pair(C))
    with pytest.raises(ValueError):
        ct.trsm("L", "L", "N", "N", a, pair(A), pair(B))
    # a complex CPU tensor with one goes to the oracle under 'auto', and
    # 'embed' refuses it, as JAX refuses a traced scalar there
    got = ct.gemm("N", "N", a, t(A), t(B), 1.0, t(C))
    np.testing.assert_allclose(got.numpy(), 0.5 * A @ B + C, atol=1e-12)
    with pytest.raises(ValueError):
        ct.gemm("N", "N", a, t(A), t(B), 1.0, t(C), backend="embed")


# ---------------------------------------------------------------------------
# the oracle tier in c/z against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,uplo", [(np.complex64, "L"),
                                        (np.complex128, "U")])
def test_lapack_ref_vs_jax(dtype, uplo):
    n = 32
    A = hpd_np(n, dtype, seed=26)
    F, info = lapack_ref.potrf(uplo, t(A), block_size=16)
    Fj, info_j = jcall(jlapack.potrf, uplo, A, block_size=16)
    assert int(info) == int(info_j) == 0
    assert_close(F.numpy(), np.asarray(Fj), dtype, 8 * n, "potrf oracle")
    F2, _ = lapack_ref.potf2(uplo, t(A))
    assert_close(F2.numpy(), np.asarray(Fj), dtype, 8 * n, "potf2 oracle")
    R = lapack_ref.lauu2(uplo, F)
    Rj = jcall(jlapack.lauu2, uplo, Fj)
    assert_close(R.numpy(), np.asarray(Rj), dtype, 2 * n + 3, "lauu2")
    assert np.all(np.diagonal(R.numpy()).imag == 0)
    W, info = lapack_ref.trti2(uplo, "N", F)
    Wj, _ = jcall(jlapack.trti2, uplo, "N", Fj)
    assert int(info) == 0
    assert_close(W.numpy(), np.asarray(Wj), dtype, 60 * n, "trti2")
