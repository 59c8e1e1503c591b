"""The d tier as a whole: cholesky_tpu_torch's dpotrf, dlogdet, dtrtri,
dlauum, dpotri and dtrsm with backend="ozaki" against cholesky_tpu's
blocked drivers with backend="ozaki" (its Pallas kernels in interpret
mode), on the same numpy matrices. The port has one recursion of each
driver, whose one peel of the factor serves every block product; the JAX
package has two, the hoisted peel and the per-call peel, and each parity
case holds the port against both (forced through the JAX package's
_OZAKI_HOIST_OVERRIDE). On the CPU the port's kernel wrappers run their
twins.

Bounds: the JAX package's own (tests/test_ozaki.py): 1e-9 relative for a
factor, 1e-8 for an inverse or a solve, 1e-7 absolute for potri and 1e-9
relative for logdet against numpy; the two packages within the same
bounds of each other, and info equal."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu_torch.ops import blocked as tblocked
from cholesky_tpu_torch.ops import ozaki
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401


def spd_np(n, cond=100.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return 0.5 * (A + A.T)


def tri_np(n, uplo, seed=2):
    """A well-conditioned triangular matrix, unit diagonal or not."""
    rng = np.random.default_rng(seed)
    T = np.tril(rng.uniform(-0.5, 0.5, (n, n)) / np.sqrt(n)) + np.diag(
        rng.uniform(1.0, 2.0, n))
    return T if uplo == "L" else T.T.copy()


@pytest.fixture(params=[True, False], ids=["jax_hoist", "jax_prehoist"])
def hoist(request, monkeypatch):
    """Both recursion variants of the JAX package, whatever its size gate
    says (tests/test_ozaki.py:25-32)."""
    monkeypatch.setattr(jblocked, "_OZAKI_HOIST_OVERRIDE", request.param)
    return request.param


def rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("n,bs,uplo", [(200, 64, "L"), (200, 64, "U"),
                                       (320, None, "L")])
def test_dpotrf_vs_jax(n, bs, uplo, hoist):
    A = spd_np(n)
    F_j, info_j = jblocked.potrf(uplo, jnp.asarray(A), backend="ozaki",
                                 block_size=bs)
    F, info = ct.dpotrf(uplo, torch.from_numpy(A), backend="ozaki",
                        block_size=bs)
    assert int(info) == int(info_j) == 0
    tri = np.tril if uplo == "L" else np.triu
    L = np.linalg.cholesky(A)
    ref = L if uplo == "L" else L.T
    assert rel(tri(F.numpy()), tri(np.asarray(F_j))) < 1e-9
    assert rel(tri(F.numpy()), ref) < 1e-9
    # the opposite strict triangle is the caller's
    other = np.triu if uplo == "L" else np.tril
    k = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(F.numpy(), k), other(A, k))


def test_dlogdet_and_dpotri_vs_jax(hoist):
    A = spd_np(192, 30.0, seed=1)
    val, info = ct.dlogdet("L", torch.from_numpy(A), backend="ozaki",
                           block_size=64)
    val_j, _ = jblocked.logdet("L", jnp.asarray(A), backend="ozaki",
                               block_size=64)
    ref = np.linalg.slogdet(A)[1]
    assert int(info) == 0
    assert abs(float(val) - ref) < 1e-9 * abs(ref) + 1e-9
    assert abs(float(val) - float(val_j)) < 1e-9 * abs(ref) + 1e-9
    F = np.linalg.cholesky(A)
    inv, info = ct.dpotri("L", torch.from_numpy(F), backend="ozaki",
                          block_size=64)
    inv_j, info_j = jblocked.potri("L", jnp.asarray(F), backend="ozaki",
                                   block_size=64)
    assert int(info) == int(info_j) == 0
    got = np.tril(inv.numpy())
    assert np.max(np.abs(got - np.tril(np.linalg.inv(A)))) < 1e-7
    assert np.max(np.abs(got - np.tril(np.asarray(inv_j)))) < 1e-7


def test_dlauum_vs_jax(hoist):
    L = tri_np(192, "L", seed=4)
    got = ct.dlauum("L", torch.from_numpy(L), backend="ozaki", block_size=64)
    ref = jblocked.lauum("L", jnp.asarray(L), backend="ozaki", block_size=64)
    assert rel(np.tril(got.numpy()), np.tril(np.asarray(ref))) < 1e-9
    assert rel(np.tril(got.numpy()), np.tril(L.T @ L)) < 1e-9


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_dtrtri_vs_jax(uplo, diag, hoist):
    T = tri_np(200, uplo)
    W, info = ct.dtrtri(uplo, diag, torch.from_numpy(T), backend="ozaki",
                        block_size=64)
    W_j, info_j = jblocked.trtri(uplo, diag, jnp.asarray(T), backend="ozaki",
                                 block_size=64)
    assert int(info) == int(info_j) == 0
    tri = np.tril if uplo == "L" else np.triu
    M = tri(T).copy()
    if diag == "U":
        np.fill_diagonal(M, 1.0)
    ref = np.linalg.inv(M)
    if diag == "U":
        np.fill_diagonal(ref, np.diag(T))       # passes through untouched
    assert rel(tri(W.numpy()), ref) < 1e-8
    assert rel(tri(W.numpy()), tri(np.asarray(W_j))) < 1e-8


# two combinations land on trsm_lln and two on trsm_llt after the port's
# canonicalization (right side: transposed; upper: the lower form of Aᵀ)
@pytest.mark.parametrize("side,uplo,trans,diag", [
    ("L", "L", "N", "N"), ("L", "U", "N", "U"), ("R", "L", "N", "N"),
    ("R", "U", "N", "U")])
def test_dtrsm_vs_jax(side, uplo, trans, diag, hoist):
    na = 200 if side == "L" else 96
    T = tri_np(na, uplo, seed=3)
    B = np.random.default_rng(4).standard_normal((200, 96))
    X = ct.dtrsm(side, uplo, trans, diag, 0.9, torch.from_numpy(T),
                 torch.from_numpy(B), backend="ozaki", block_size=64)
    X_j = jblocked.trsm(side, uplo, trans, diag, 0.9, jnp.asarray(T),
                        jnp.asarray(B), backend="ozaki", block_size=64)
    M = np.tril(T) if uplo == "L" else np.triu(T)
    if diag == "U":
        np.fill_diagonal(M, 1.0)
    M = M if trans == "N" else M.T
    ref = (np.linalg.solve(M, 0.9 * B) if side == "L"
           else np.linalg.solve(M.T, 0.9 * B.T).T)
    assert rel(X.numpy(), ref) < 1e-8
    assert rel(X.numpy(), np.asarray(X_j)) < 1e-8


def test_hoisted_recursions_leave_no_cyclic_garbage():
    # every peel of a hoisted recursion is freed when the driver returns,
    # not held by the recursion's closure until a cyclic collection (GBs
    # of the card's memory at n = 8192)
    A = torch.from_numpy(spd_np(200))
    B = torch.from_numpy(np.random.default_rng(4).standard_normal((200, 96)))
    gc.collect()
    gc.disable()
    try:
        F, _ = ct.dpotrf("L", A, backend="ozaki", block_size=64)
        ct.dpotri("L", F, backend="ozaki", block_size=64)
        for trans in "NT":
            ct.dtrsm("L", "L", trans, "N", 1.0, F, B, backend="ozaki",
                     block_size=64)
        ct.dtrmm("L", "L", "N", "N", 1.0, F, B, backend="ozaki")
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_dpotrf_f64_rescue():
    # PD in f64 but singular in f32: the f32 leaf flags pivot 2, the second
    # pass re-factors that leaf in f64 and reports info 0, as the JAX
    # package's lax.cond does (test_ozaki.py:71-97)
    a, delta = 0.5, 1e-12
    A = np.array([[1.0, a], [a, a * a + delta]])
    F, info = ct.dpotrf("L", torch.from_numpy(A), backend="ozaki")
    _, info_j = jblocked.potrf("L", jnp.asarray(A), backend="ozaki")
    assert int(info) == int(info_j) == 0
    L = np.tril(F.numpy())
    assert np.max(np.abs(L @ L.T - A)) < 1e-15
    # truly non-PD: the f64 verdict confirms pivot 2, everything finite
    B = np.array([[1.0, a], [a, a * a - 1e-6]])
    F, info = ct.dpotrf("L", torch.from_numpy(B), backend="ozaki")
    assert int(info) == 2
    assert np.all(np.isfinite(F.numpy()))


def test_dpotrf_nonpd_vs_jax():
    A = spd_np(320, seed=5)
    A[100, 100] = -3.0
    F, info = ct.dpotrf("L", torch.from_numpy(A), backend="ozaki")
    F_j, info_j = jblocked.potrf("L", jnp.asarray(A), backend="ozaki")
    assert int(info) == int(info_j) == 101
    lead = np.tril(F.numpy()[:100, :100])
    assert np.all(np.isfinite(lead))
    assert rel(lead, np.tril(np.asarray(F_j)[:100, :100])) < 1e-9


@pytest.mark.parametrize("alpha,beta", [(-1.0, 1.0), (1.0, 0.0)])
@pytest.mark.parametrize("shape", [(64, 64), (200, 96), (96, 200)])
def test_syrk_ln_is_the_two_peel_product_bit_for_bit(shape, alpha, beta):
    # the one-peel syrk_ln (dsyrk, _potrf_lower, _lauum_lower) against the
    # product with A and Aᵀ peeled apart: split_rows(A) and
    # split_rows((Aᵀ)ᵀ) are the same peel while k <= K_EXACT_MAX
    rng = np.random.default_rng(9)
    A = torch.from_numpy(rng.standard_normal(shape))
    C0 = torch.from_numpy(rng.standard_normal((shape[0], shape[0])))
    C = C0.clone()
    tblocked._OzakiTiles().syrk_ln(alpha, A, beta, C)
    want = ozaki.matmul_f64(A, A.T, slices=6, out=C0.clone(), alpha=alpha,
                            beta=beta)
    assert torch.equal(C, want)


def test_backend_routing_for_f64():
    A = torch.zeros(8, 8, dtype=torch.float64)
    # a CPU tensor under auto stays on the torch tile; 'ozaki' is asked for
    assert isinstance(tblocked._tiles_for(A, "auto"), tblocked._TorchTiles)
    assert isinstance(tblocked._tiles_for(A, "ozaki"), tblocked._OzakiTiles)
    with pytest.raises(ValueError):
        tblocked._tiles_for(A.float(), "ozaki")
    with pytest.raises(ValueError):
        tblocked._tiles_for(A, "cuda")            # a CPU tensor


@pytest.mark.parametrize("name,args", [
    ("dpotrf", ("L",)), ("dlogdet", ("L",)), ("dpotri", ("L",)),
    ("dtrtri", ("L", "N")), ("dlauum", ("L",)), ("spotrf", ("L",))])
def test_typed_wrappers_refuse_the_other_dtype(name, args):
    seen = []
    prev = ct.set_xerbla(lambda routine, arg, msg="": seen.append(
        (routine, arg)))
    dtype = torch.float64 if name[0] == "s" else torch.float32
    try:
        with pytest.raises(ValueError, match="expected"):
            getattr(ct, name)(*args, torch.eye(4, dtype=dtype))
    finally:
        ct.set_xerbla(prev)
    assert seen == [(name, len(args) + 1)]


def test_dtrsm_refuses_float32():
    with pytest.raises(ValueError, match="expected torch.float64"):
        ct.dtrsm("L", "L", "N", "N", 1.0, torch.eye(4), torch.ones(4, 2))


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hoisted_drivers_with_block_size_40_vs_jax(uplo, monkeypatch):
    # a block size that is not a multiple of 16: the hoisted recursions
    # slice one peel at k offsets 40, 80, ... (on the card the wrapper
    # realigns those rows); dpotrf, dtrsm both ways, dtrtri and dpotri
    monkeypatch.setattr(jblocked, "_OZAKI_HOIST_OVERRIDE", True)
    A = spd_np(120, seed=6)
    F, info = ct.dpotrf(uplo, torch.from_numpy(A), backend="ozaki",
                        block_size=40)
    F_j, info_j = jblocked.potrf(uplo, jnp.asarray(A), backend="ozaki",
                                 block_size=40)
    assert int(info) == int(info_j) == 0
    tri = np.tril if uplo == "L" else np.triu
    assert rel(tri(F.numpy()), tri(np.asarray(F_j))) < 1e-9
    T = tri_np(120, uplo, seed=7)
    B = np.random.default_rng(8).standard_normal((120, 8))
    for trans in ("N", "T"):
        X = ct.dtrsm("L", uplo, trans, "N", 1.0, torch.from_numpy(T),
                     torch.from_numpy(B), backend="ozaki", block_size=40)
        X_j = jblocked.trsm("L", uplo, trans, "N", 1.0, jnp.asarray(T),
                            jnp.asarray(B), backend="ozaki", block_size=40)
        M = tri(T) if trans == "N" else tri(T).T
        assert rel(X.numpy(), np.linalg.solve(M, B)) < 1e-8
        assert rel(X.numpy(), np.asarray(X_j)) < 1e-8
    W, info = ct.dtrtri(uplo, "N", torch.from_numpy(T), backend="ozaki",
                        block_size=40)
    W_j, _ = jblocked.trtri(uplo, "N", jnp.asarray(T), backend="ozaki",
                            block_size=40)
    assert int(info) == 0
    assert rel(tri(W.numpy()), tri(np.asarray(W_j))) < 1e-8
    assert rel(tri(W.numpy()), np.linalg.inv(tri(T))) < 1e-8
