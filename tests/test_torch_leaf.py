"""The leaf kernels potf2_f32 and trti2_f32 (cholesky_tpu_torch/ops/kernels/
leaf.py) and the routing repairs that reach them. On the CPU each wrapper
runs its plain torch twin, held here against the Pallas kernel it replaces
(cholesky_tpu/ops/pallas/leaf.py) in interpret mode, as
tests/test_pallas_kernels.py runs it. The CUDA kernels are held against
their twins on the card by tests/test_torch_cuda.py.

Tolerances are the repo's eps-scaled bounds (tests/util.py): 8n for a
Cholesky factor, 60n for a triangular inverse. Past a failed pivot only
info and the leading (info-1) block are compared (ROADMAP Queue 3)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu.tuning
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu.ops.pallas import leaf as pleaf
from cholesky_tpu_torch.ops import blocked as tblocked
from cholesky_tpu_torch.ops import kernels
from cholesky_tpu_torch.ops.kernels import leaf, potf2_f32, trti2_f32
from tests.util import assert_close

F32 = np.float32


def spd_np(n, cond=50.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return (0.5 * (A + A.T)).astype(F32)


def tri_np(n, seed=2):
    """A well-conditioned lower-triangular f32 matrix, garbage above."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(-0.5, 0.5, (n, n)) / np.sqrt(n) + np.diag(
        rng.uniform(1.0, 2.0, n))
    return T.astype(F32)


# ---------------------------------------------------------------------------
# potf2_f32 — replaces ops/pallas/leaf.py:potf2_f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 128, 256])
def test_potf2_twin_vs_pallas(n):
    A = spd_np(n)
    At = torch.from_numpy(A.copy())
    At[np.triu_indices(n, 1)] = np.nan          # the strict upper is unread
    info = potf2_f32(At)
    L, info_j = pleaf.potf2_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == 0
    assert info.dtype == torch.int32 and info.ndim == 0
    got = At.numpy()
    assert np.all(np.triu(got, 1) == 0.0)
    assert_close(got, np.asarray(L), F32, 8 * n, f"potf2 n={n}")


@pytest.mark.parametrize("n,k,value", [(256, 200, -1.0), (256, 7, np.nan),
                                       (100, 40, -3.0)])
def test_potf2_failed_pivot(n, k, value):
    # info from both; the port's factor stays finite but for an input NaN
    # pivot, and its leading block before the pivot is right. The JAX leaf
    # smears a NaN pivot over its whole factor (its selector products take
    # 0·NaN, as its oracle does: ROADMAP Queue 3), so the leading block is
    # held against numpy, and against JAX where JAX's is finite.
    A = spd_np(n, cond=10.0)
    A[k, k] = value
    At = torch.from_numpy(A.copy())
    info = potf2_f32(At)
    L, info_j = pleaf.potf2_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == k + 1
    bad = {tuple(ix) for ix in np.argwhere(~np.isfinite(At.numpy()))}
    assert bad <= {(k, k)}
    lead = At.numpy()[:k, :k]
    ref = np.linalg.cholesky(A[:k, :k].astype(np.float64))
    assert_close(lead, ref, F32, 8 * n, "potf2 leading block")
    if not np.isnan(value):
        assert_close(lead, np.asarray(L)[:k, :k], F32, 8 * n,
                     "potf2 leading block vs JAX")


def test_potf2_on_a_view():
    # a diagonal block of a working buffer: rows longer than the block
    A = spd_np(256)
    buf = torch.zeros(256, 384)
    buf[:, 64:320] = torch.from_numpy(A)
    assert int(potf2_f32(buf[:, 64:320])) == 0
    L, _ = pleaf.potf2_f32(jnp.asarray(A))
    assert_close(buf[:, 64:320].numpy(), np.asarray(L), F32, 8 * 256,
                 "potf2 view")
    assert torch.all(buf[:, :64] == 0) and torch.all(buf[:, 320:] == 0)


@pytest.mark.parametrize("n", [128, 256, 384])
@pytest.mark.parametrize("kb", [128, 256])
def test_potf2_strips_vs_pallas(n, kb, monkeypatch):
    # the two-level walk: panels inside a strip of kb columns, then one
    # trailing product of depth kb a strip
    monkeypatch.setattr(leaf, "POTF2_KB", kb)
    A = spd_np(n, seed=n + kb)
    At = torch.from_numpy(A.copy())
    At[np.triu_indices(n, 1)] = np.nan
    info = potf2_f32(At)
    L, info_j = pleaf.potf2_f32(jnp.asarray(A))
    assert int(info) == int(info_j) == 0
    assert np.all(np.triu(At.numpy(), 1) == 0.0)
    assert_close(At.numpy(), np.asarray(L), F32, 8 * n,
                 f"potf2 n={n} kb={kb}")


@pytest.mark.parametrize("k,value", [(200, -1.0), (300, -1.0), (255, -2.0),
                                     (130, np.nan)])
def test_potf2_strips_failed_pivot(k, value, monkeypatch):
    # n = 384 in strips of 256: a failure inside the first strip (k = 200,
    # its second panel; k = 255, its last row), in the second (300), and a
    # NaN pivot; info, finite but an input NaN, the leading block right.
    # The JAX leaf smears a NaN pivot over its panel (ROADMAP Queue 3) and
    # reports that panel's first pivot, so a NaN's info is held to k + 1.
    monkeypatch.setattr(leaf, "POTF2_KB", 256)
    n = 384
    A = spd_np(n, cond=10.0, seed=5)
    A[k, k] = value
    At = torch.from_numpy(A.copy())
    info = potf2_f32(At)
    L, info_j = pleaf.potf2_f32(jnp.asarray(A))
    assert int(info) == k + 1
    assert np.isnan(value) or int(info_j) == k + 1
    bad = {tuple(ix) for ix in np.argwhere(~np.isfinite(At.numpy()))}
    assert bad <= {(k, k)}
    lead = At.numpy()[:k, :k]
    ref = np.linalg.cholesky(A[:k, :k].astype(np.float64))
    assert_close(lead, ref, F32, 8 * n, "potf2 strips leading block")
    if not np.isnan(value):
        assert_close(lead, np.asarray(L)[:k, :k], F32, 8 * n,
                     "potf2 strips leading block vs JAX")


@pytest.mark.parametrize("n,kb,want", [
    (100, 512, [(0, 100)]),
    (512, 512, [(0, 512)]),
    (1280, 512, [(0, 512), (512, 1024), (1024, 1280)]),
    (16384, 1024, [(j, j + 1024) for j in range(0, 16384, 1024)]),
])
def test_potf2_strips_plan(n, kb, want):
    assert leaf.potf2_strips(n, kb) == want


# ---------------------------------------------------------------------------
# trti2_f32 — replaces ops/pallas/leaf.py:trti2_f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 128, 256, 384])
@pytest.mark.parametrize("unit", [False, True])
def test_trti2_twin_vs_pallas(n, unit):
    # 384: three leaves, a level whose last leaf has no partner and one
    # whose C is short (mega.trtri_levels), in the twin's order of work
    T = tri_np(n)
    Tn = torch.from_numpy(T.copy())
    Tn[np.triu_indices(n, 1)] = np.nan          # the strict upper is unread
    W, info = trti2_f32(Tn, unit=unit)
    ref, info_j = jax.jit(functools.partial(pleaf.trti2_f32, unit=unit))(
        jnp.asarray(T))
    assert int(info) == int(info_j) == 0
    got, ref = W.numpy(), np.asarray(ref)
    assert np.all(np.triu(got, 1) == 0.0)
    assert_close(got, ref, F32, 60 * n, f"trti2 n={n} unit={unit}")
    if unit:        # the diagonal passes through, bit for bit, in both
        np.testing.assert_array_equal(np.diag(got), np.diag(T))
        np.testing.assert_array_equal(np.diag(ref), np.diag(T))


def test_trti2_zero_diagonal():
    # one zero: info 10 in both, read as 1, the result finite (with
    # several zeros the JAX kernel reports the largest, ROADMAP Queue 3)
    T = np.tril(tri_np(256))
    T[9, 9] = 0.0
    W, info = trti2_f32(torch.from_numpy(T))
    ref, info_j = pleaf.trti2_f32(jnp.asarray(T))
    assert int(info) == int(info_j) == 10
    assert torch.isfinite(W).all()
    assert_close(W.numpy(), np.asarray(ref), F32, 60 * 256, "trti2 zero diag")


def test_trti2_levels_zero_diagonal():
    # one zero in the second leaf: info 201 in both, read as 1, finite
    T = np.tril(tri_np(384, seed=5))
    T[200, 200] = 0.0
    W, info = leaf.trti2_plain(torch.from_numpy(T))
    ref, info_j = jax.jit(pleaf.trti2_f32)(jnp.asarray(T))
    assert int(info) == int(info_j) == 201
    assert torch.isfinite(W).all()
    assert_close(W.numpy(), np.asarray(ref), F32, 60 * 384,
                 "trti2 levels zero diag")


@pytest.mark.parametrize("kernel", [potf2_f32, trti2_f32])
def test_leaf_rejects_what_the_kernel_does_not_take(kernel):
    with pytest.raises(ValueError):
        kernel(torch.eye(200))                      # not <= 128 nor 128k
    with pytest.raises(ValueError):
        kernel(torch.eye(256, dtype=torch.float64))  # f64
    with pytest.raises(ValueError):
        kernel(torch.rand(256, 256).T)              # column-major
    with pytest.raises(ValueError):
        kernel(torch.eye(4, 5))                     # not square


# ---------------------------------------------------------------------------
# the routing: blocks the whole-matrix kernels refuse reach the leaves
# ---------------------------------------------------------------------------

def test_kernel_tiles_fall_through_to_the_leaves(monkeypatch):
    # where _mega_ok refuses a block, both packages' kernel tiles run the
    # leaf kernels (JAX blocked.py:189-209); here the twins, no launches
    monkeypatch.setattr(tblocked, "_mega_ok", lambda n, op="potrf": False)
    monkeypatch.setattr(jblocked, "_mega_ok", lambda n, op="potrf": False)
    t, tj = tblocked._KernelTiles(), jblocked._PallasTiles()
    kernels.reset_launch_counts()
    A = spd_np(256)
    At = torch.from_numpy(A.copy())
    info = t.potf2(At)
    L, info_j = tj.potf2(jnp.asarray(A))
    assert int(info) == int(info_j) == 0
    assert_close(np.tril(At.numpy()), np.tril(np.asarray(L)), F32, 8 * 256,
                 "kernel tiles potf2")
    T = tri_np(256, seed=3)
    for unit in (False, True):
        W, info = t.trti2(torch.from_numpy(T), unit=unit)
        Wj, info_j = tj.trti2(jnp.asarray(T), unit=unit)
        assert int(info) == int(info_j) == 0
        assert_close(W.numpy(), np.asarray(Wj), F32, 60 * 256,
                     f"kernel tiles trti2 unit={unit}")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def tuned(cap):
    """A get_params whose potrf/trtri/lauum mega_max_n is ``cap``."""
    def get_params(op, device_kind=None):
        if op in ("potrf_f32", "trtri_f32", "lauum_f32"):
            return {"leaf_nb": 128, "mega_max_n": cap}
        return {}
    return get_params


@pytest.mark.parametrize("op", ["potrf", "trtri", "lauum"])
def test_mega_ok_matches_jax_under_a_small_cap(op, monkeypatch):
    # a tuned cap below 1024 (a sweep on the H100 found 256 faster) must
    # not take n <= 1024 away from the whole-block kernels (JAX
    # blocked.py:64-65)
    monkeypatch.setattr(tblocked, "get_params", tuned(256))
    monkeypatch.setattr(cholesky_tpu.tuning, "get_params", tuned(256))
    for n in (1, 100, 128, 200, 256, 384, 512, 1024, 1025, 1152, 2048,
              8192, 8320):
        assert tblocked._mega_ok(n, op) == jblocked._mega_ok(n, op), n
    assert tblocked._mega_ok(512, op) and not tblocked._mega_ok(1152, op)


def test_potrf_recursion_routes_as_jax_under_a_small_cap(monkeypatch):
    # the same leaves in both packages' recursions, and the same factor
    monkeypatch.setattr(tblocked, "get_params", tuned(256))
    monkeypatch.setattr(cholesky_tpu.tuning, "get_params", tuned(256))
    seen, seen_j = [], []
    real, real_j = tblocked._KernelTiles.potf2, jblocked._PallasTiles.potf2
    monkeypatch.setattr(tblocked._KernelTiles, "potf2", staticmethod(
        lambda A: seen.append(A.shape[0]) or real(A)))
    monkeypatch.setattr(jblocked._PallasTiles, "potf2",
                        lambda self, A: seen_j.append(A.shape[0])
                        or real_j(self, A))
    A = spd_np(512)
    W = torch.from_numpy(A.copy())
    info = tblocked._potrf_lower(W, tblocked._KernelTiles(), 128, True)
    F, info_j = jblocked._potrf_lower(jnp.asarray(A), jblocked._PallasTiles(),
                                      128, True)
    assert int(info) == int(info_j) == 0
    assert seen == seen_j == [512]          # one whole-block call in each
    assert_close(np.tril(W.numpy()), np.tril(np.asarray(F)), F32, 8 * 512,
                 "potrf under a small cap")


def test_lauum_leaves_above_1024_reach_lauu2(monkeypatch):
    # lauu2_f32 takes any n, as the Pallas leaf does: lauum with a block
    # size above 1024 hands its leaves to it (here its twin); it used to
    # raise NotImplementedError on the card
    seen = []
    real = tblocked._KernelTiles.lauu2
    monkeypatch.setattr(tblocked._KernelTiles, "lauu2", staticmethod(
        lambda L: seen.append(L.shape[0]) or real(L)))
    n, nb = 2176, 1088
    L = np.tril(tri_np(n, seed=4))
    W = torch.from_numpy(L.copy())
    kernels.reset_launch_counts()
    tblocked._lauum_lower(W, tblocked._KernelTiles(), nb, False)
    assert seen == [nb, nb]
    L64 = L.astype(np.float64)
    assert_close(np.tril(W.numpy()), np.tril(L64.T @ L64), F32, 2 * n + 3,
                 "lauum on 1088 leaves")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
