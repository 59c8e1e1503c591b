"""The d tier's products (cholesky_tpu_torch/ops/ozaki.py and the two
kernels of ops/kernels/ozaki.py) against cholesky_tpu/ops/ozaki.py and its
Pallas kernels, run in interpret mode as tests/test_ozaki.py runs them, on
the same numpy inputs. On the CPU the wrappers run their plain twins; the
CUDA kernels are held against the twins on the card by
tests/test_torch_cuda.py.

Bounds: the peel and the row scales are bit for bit (the peel is exact
arithmetic); the grouped products within 1e-12·max|ref| of the JAX kernel
(the bound of test_ozaki.py's fused-against-XLA test: the pair carries
about 48 bits, below the 2^(-7S) floor of the dropped pairs); matmul_f64
within the JAX package's own bounds (test_ozaki.py:35-68)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cholesky_tpu.ops import ozaki as jozaki
from cholesky_tpu.ops.pallas.ozaki_mm import mm_groups_f32pair as j_mm
from cholesky_tpu.ops.pallas.ozaki_split import peel_f32pair as j_peel
from cholesky_tpu_torch.ops import kernels, ozaki
from cholesky_tpu_torch.ops.kernels.ozaki import (ALIGN, _pow2_f32,
                                                  aligned_rows,
                                                  mm_groups_f32pair,
                                                  mm_groups_plain,
                                                  peel_f32pair, peel_plain,
                                                  scaled_pair)


def rnd(seed, shape, spread=False):
    r = np.random.RandomState(seed)
    x = r.randn(*shape)
    if spread:
        x = x * np.exp(2.0 * r.randn(*shape))   # wide dynamic range
    return x


def pair(seed, shape):
    """An exact f32 pair of values in [-1/2, 1/2], as split_rows makes."""
    x = np.random.RandomState(seed).uniform(-0.5, 0.5, shape)
    rh = x.astype(np.float32)
    return rh, (x - rh.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("slices", [4, 6])
def test_peel_bit_exact_vs_jax_kernel(slices):
    rh, rl = pair(0, (200, 300))
    ref = np.asarray(j_peel(jnp.asarray(rh), jnp.asarray(rl), slices=slices))
    got = peel_plain(torch.from_numpy(rh), torch.from_numpy(rl), slices)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the wrapper takes the twin for a CPU tensor, strided views included
    got = peel_f32pair(torch.from_numpy(rh.T.copy()).T,
                       torch.from_numpy(rl), slices=slices)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("slices", [4, 6])
def test_split_rows_bit_exact_vs_jax(spread, slices):
    A = rnd(1, (96, 200), spread)
    A[5] = 0.0                                  # a zero row: scale 2
    js, jsc = jozaki.split_rows(jnp.asarray(A), slices)
    ts, tsc = ozaki.split_rows(torch.from_numpy(A), slices)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    # a transposed view, as matmul_f64 peels B.T
    js, jsc = jozaki.split_rows(jnp.asarray(A.T.copy()), slices)
    ts, tsc = ozaki.split_rows(torch.from_numpy(A).T, slices)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_pow2_is_exact_over_the_f32_range():
    e = np.arange(-160, 140, dtype=np.int32)
    got = _pow2_f32(torch.from_numpy(e)).numpy()
    with np.errstate(over="ignore"):            # 2^128 and up: inf
        want = np.ldexp(np.float32(1.0), e).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def peeled(seed_a, seed_b, m, n, k, slices=6, spread=True):
    A = rnd(seed_a, (m, k), spread)
    B = rnd(seed_b, (k, n), spread)
    As, asc = jozaki.split_rows(jnp.asarray(A), slices)
    Bs, bsc = jozaki.split_rows(jnp.asarray(B.T.copy()), slices)
    return A, B, (As, asc, Bs, bsc)


def test_mm_groups_twin_vs_jax_kernel():
    _, _, (As, _, Bs, _) = peeled(11, 12, 192, 160, 640)
    hi_j, lo_j = j_mm(As, Bs)
    ref = np.asarray(hi_j, np.float64) + np.asarray(lo_j, np.float64)
    hi, lo = mm_groups_plain(torch.from_numpy(np.array(As)),
                             torch.from_numpy(np.array(Bs)))
    assert hi.dtype == lo.dtype == torch.float32
    got = hi.double().numpy() + lo.double().numpy()
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 1e-12
    # |lo| <= ulp(hi) / 2: a renormalized pair
    assert np.all(np.abs(lo.numpy()) <= np.spacing(np.abs(hi.numpy())))


def test_matmul_presplit_vs_jax():
    A, B, (As, asc, Bs, bsc) = peeled(11, 12, 192, 160, 640)
    ref = np.asarray(jozaki.matmul_presplit(As, asc, Bs, bsc, fused=False))
    t = [torch.from_numpy(np.array(x)) for x in (As, asc, Bs, bsc)]
    got = ozaki.matmul_presplit(*t).numpy()
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 1e-12
    assert np.max(np.abs(got - A @ B)) / scale < 1e-9


@pytest.mark.parametrize("update", ["sub", "copy", "add", "scaled", "none"])
def test_matmul_presplit_update_matches_the_composed_passes(update):
    # out=, alpha=, beta= give bit for bit what the d tier's callers
    # composed around the product: B -= P, C.copy_(P), C += P,
    # alpha·P + beta·C, alpha·P; out a strided view of a wider matrix
    As, asc = ozaki.split_rows(torch.from_numpy(rnd(21, (20, 40), True)), 6)
    Bs, bsc = ozaki.split_rows(torch.from_numpy(rnd(22, (12, 40))), 6)
    hi, lo = mm_groups_f32pair(As, Bs)
    P = (hi.double() + lo.double()) * asc[:, None] * bsc[None, :]
    big = torch.from_numpy(rnd(23, (30, 24)))
    before = big.clone()
    out = big[3:23, 5:17]
    ref = out.clone()
    alpha, beta = {"sub": (-1.0, 1.0), "copy": (1.0, 0.0), "add": (1.0, 1.0),
                   "scaled": (-0.5, 2.0), "none": (0.75, 0.0)}[update]
    if update == "sub":
        ref -= P
    elif update == "copy":
        ref = P
    elif update == "add":
        ref += P
    else:
        ref = alpha * P
        if beta != 0.0:
            ref = ref + beta * out
    if update == "none":
        got = ozaki.matmul_presplit(As, asc, Bs, bsc, alpha=alpha)
    else:
        got = ozaki.matmul_presplit(As, asc, Bs, bsc, out=out, alpha=alpha,
                                    beta=beta)
        assert got is out
        outside = torch.ones_like(big, dtype=torch.bool)
        outside[3:23, 5:17] = False
        assert torch.equal(big[outside], before[outside])
    assert torch.equal(got, ref)


@pytest.mark.parametrize("k", [64, 300])
@pytest.mark.parametrize("spread", [False, True])
def test_matmul_f64_accuracy(k, spread):
    A = rnd(0, (160, k), spread)
    B = rnd(1, (k, 120), spread)
    ref = A @ B
    for S, bound in [(4, 3e-6), (6, 1e-9)]:
        C = ozaki.matmul_f64(torch.from_numpy(A), torch.from_numpy(B),
                             slices=S)
        rel = np.max(np.abs(C.numpy() - ref)) / np.max(np.abs(ref))
        assert rel < bound, (S, rel)
        J = np.asarray(jozaki.matmul_f64(jnp.asarray(A), jnp.asarray(B),
                                         slices=S))
        assert np.max(np.abs(C.numpy() - J)) / np.max(np.abs(ref)) < 1e-12


def test_matmul_f64_exact_small_ints():
    A = np.random.RandomState(2).randint(-50, 50, (64, 64)).astype(
        np.float64)
    B = np.random.RandomState(3).randint(-50, 50, (64, 64)).astype(
        np.float64)
    C = ozaki.matmul_f64(torch.from_numpy(A), torch.from_numpy(B), slices=4)
    np.testing.assert_array_equal(C.numpy(), A @ B)


def test_k_beyond_exact_bound_chunks():
    k = ozaki.K_EXACT_MAX + 128
    assert ozaki.K_EXACT_MAX == jozaki.K_EXACT_MAX
    rs = np.random.RandomState(7)
    A = rs.uniform(-1, 1, (4, k))
    B = rs.uniform(-1, 1, (k, 4))
    C = ozaki.matmul_f64(torch.from_numpy(A), torch.from_numpy(B), slices=6)
    np.testing.assert_allclose(C.numpy(), A @ B, rtol=0, atol=k * 2.0 ** -40)
    # the presplit entry chunks its own way, to the same bound
    As, asc = ozaki.split_rows(torch.from_numpy(A), 6)
    Bs, bsc = ozaki.split_rows(torch.from_numpy(B).T, 6)
    C = ozaki.matmul_presplit(As, asc, Bs, bsc)
    np.testing.assert_allclose(C.numpy(), A @ B, rtol=0, atol=k * 2.0 ** -40)


def test_cancellation_stays_below_the_floor():
    # T = L·L⁻¹ ≈ I, the Newton step's product (test_ozaki.py:305-322)
    n = 640
    r = np.random.RandomState(9)
    G = r.randn(n, n)
    L = np.linalg.cholesky(G @ G.T + n * np.eye(n))
    W = np.linalg.inv(L)
    T = ozaki.matmul_f64(torch.from_numpy(L), torch.from_numpy(W),
                         slices=6).numpy()
    assert np.max(np.abs(T - L @ W)) < n * 2.0 ** -40


def test_kernel_wrappers_on_the_cpu():
    kernels.reset_launch_counts()
    rh, rl = pair(3, (10, 7))
    S = peel_f32pair(torch.from_numpy(rh), torch.from_numpy(rl), slices=6)
    hi, lo = mm_groups_f32pair(S, S)
    assert S.shape == (6, 10, 7) and hi.shape == lo.shape == (10, 10)
    # the twins ran: nothing was launched
    assert kernels.launch_counts()["peel_f32pair"] == 0
    assert kernels.launch_counts()["mm_groups_f32pair"] == 0


def test_f64_kernel_wrappers_on_the_cpu():
    # the one-launch peel and product take their twins on the CPU: the
    # scaling passes then the peel, the pair then the epilogue passes
    kernels.reset_launch_counts()
    A = torch.from_numpy(rnd(4, (10, 7), True))
    S, sc = kernels.peel_f64(A, slices=6)
    rh, rl, want_sc = scaled_pair(A)
    assert torch.equal(S, peel_plain(rh, rl, 6)) and torch.equal(sc, want_sc)
    out = torch.ones((10, 10), dtype=torch.float64)
    got = kernels.mm_groups_f64(S, sc, S, sc, out=out, alpha=-1.0, beta=1.0)
    hi, lo = mm_groups_plain(S, S)
    P = (hi.double() + lo.double()) * sc[:, None] * sc[None, :]
    assert got is out and torch.equal(out, 1.0 - P)
    assert kernels.launch_counts()["peel_f64"] == 0
    assert kernels.launch_counts()["mm_groups_f64"] == 0
    with pytest.raises(ValueError):             # beta reads an out
        kernels.mm_groups_f64(S, sc, S, sc, beta=1.0)


@pytest.mark.parametrize("bad", ["dtype", "slices", "k", "too_many"])
def test_kernel_wrappers_refuse_bad_arguments(bad):
    S8 = torch.zeros((4, 8, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        if bad == "dtype":
            mm_groups_f32pair(S8.float(), S8)
        elif bad == "slices":
            mm_groups_f32pair(S8, S8[:3])
        elif bad == "k":
            mm_groups_f32pair(S8, S8[:, :, :8])
        else:
            peel_f32pair(torch.zeros(4, 4), torch.zeros(4, 4), slices=9)


def rows_aligned(X):
    return (X.stride(2) == 1 and X.data_ptr() % ALIGN == 0
            and X.stride(0) % ALIGN == 0 and X.stride(1) % ALIGN == 0)


@pytest.mark.parametrize("view", ["peel", "k offset 40", "k offset 3",
                                  "transposed", "odd row stride"])
def test_aligned_rows_copies_only_what_the_kernel_cannot_read(view):
    # the card's wrapper hands the kernel rows that start on ALIGN bytes
    # with a unit k stride: a misaligned view is copied once, values kept
    rh, rl = pair(4, (96, 120))
    Ls = peel_plain(torch.from_numpy(rh), torch.from_numpy(rl), 6)
    kp = torch.zeros((6, 96, 128), dtype=torch.int8)   # a peel's padded rows
    kp[:, :, :120] = Ls
    X = {"peel": kp[:, :, :120], "k offset 40": kp[:, 50:90, 40:80],
         "k offset 3": kp[:, 50:90, 3:43],
         "transposed": kp[:, :64, :64].transpose(1, 2),
         "odd row stride": Ls[:, :40, :37].contiguous()}[view]
    got = aligned_rows(X)
    assert torch.equal(got, X) and got.shape == X.shape
    assert rows_aligned(got)
    if rows_aligned(X):
        assert got.data_ptr() == X.data_ptr()       # no copy
    else:
        assert got.data_ptr() != X.data_ptr()
        assert got.stride(1) == -(-X.shape[2] // ALIGN) * ALIGN


def test_hoisted_drivers_pass_misaligned_views_that_realign(monkeypatch):
    # block_size=40 under the hoisted peel: the sub-peels start at k
    # offsets 40, 80, ... which the kernel's copies cannot read in place;
    # through aligned_rows the products are unchanged
    seen = []
    real = ozaki._kz.mm_groups_plain

    def via_aligned(As, Bs):
        seen.extend(rows_aligned(X) for X in (As, Bs))
        return real(aligned_rows(As), aligned_rows(Bs))

    monkeypatch.setattr(ozaki._kz, "mm_groups_plain", via_aligned)
    from cholesky_tpu_torch.ops import blocked as tblocked
    monkeypatch.setattr(tblocked, "_OZAKI_HOIST_OVERRIDE", True)
    rng = np.random.default_rng(5)
    G = rng.standard_normal((160, 160))
    A = G @ G.T / 160 + np.eye(160)
    F, info = tblocked.potrf("L", torch.from_numpy(A), backend="ozaki",
                             block_size=40)
    assert int(info) == 0 and not all(seen)
    L = np.linalg.cholesky(A)
    assert np.max(np.abs(np.tril(F.numpy()) - L)) < 1e-9 * np.max(np.abs(L))
