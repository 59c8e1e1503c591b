"""trmm: the kernel trmm_lln_f32 (cholesky_tpu_torch/ops/kernels/trmm.py)
and the public trmm/trmm2 over all side/uplo/trans/diag combinations.

On the CPU the kernel's wrapper runs its plain torch twin, held here
against the Pallas kernel it replaces (cholesky_tpu/ops/pallas/trmm.py) in
interpret mode, at tests/test_trmm_pallas.py's shapes. The public trmm
runs three routes on the same numpy inputs, held against the JAX package's
blocked.trmm with backend="xla": the torch tile (the CPU's default), the
kernel route (``_trmm_left_f32``, one trmm_lln_f32 call per trmm, here its
twin) and, for f64, the Ozaki tile against JAX's backend="ozaki" (its
Pallas kernels in interpret mode). TRMM_TILES_NB is patched to 64 in both
packages so that the live-block recursion and its ragged-tail absorption
run at n = 160 and 200.

Bounds: 2n+3 (tests/util.py) for the kernel and 3n+3 for the public trmm, as
tests/test_trmm_pallas.py; 1e-9 relative for the Ozaki products, as
tests/test_torch_dtier.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cholesky_tpu_torch as ct
from cholesky_tpu.ops import blocked as jblocked
from cholesky_tpu.ops.pallas import trmm as ptrmm
from cholesky_tpu_torch.ops import blocked as tblocked
from cholesky_tpu_torch.ops import kernels
from cholesky_tpu_torch.ops.kernels.trmm import trmm_lln_f32
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401
from tests.util import assert_close

F32 = np.float32


def rnd(shape, seed, dtype=F32):
    return (np.random.default_rng(seed).uniform(-0.5, 0.5, shape)
            ).astype(dtype)


@pytest.fixture
def small_nb(monkeypatch):
    monkeypatch.setattr(tblocked, "TRMM_TILES_NB", 64)
    monkeypatch.setattr(jblocked, "TRMM_TILES_NB", 64)


@pytest.mark.parametrize("n,m", [(8, 8), (128, 128), (256, 384), (200, 130),
                                 (384, 100)])
def test_trmm_lln_twin_vs_pallas(n, m):
    L = np.tril(rnd((n, n), 1))
    B = rnd((n, m), 2)
    got = trmm_lln_f32(torch.from_numpy(L), torch.from_numpy(B), alpha=2.0)
    ref = ptrmm.trmm_lln_f32(jnp.asarray(L), jnp.asarray(B), alpha=2.0)
    assert got.shape == (n, m)
    assert_close(got.numpy(), np.asarray(ref), F32, 2 * n + 3,
                 f"trmm_lln {n}x{m}")


def test_trmm_lln_reads_only_lower_and_takes_views():
    # the strict upper of L may hold NaN; L a transposed view, B a slice
    n, m = 200, 130
    U = rnd((n, n), 3)
    U[np.tril_indices(n, -1)] = np.nan               # Uᵀ's strict upper
    Lt = torch.from_numpy(U).T
    Bw = torch.from_numpy(rnd((n, m + 20), 4))
    got = trmm_lln_f32(Lt, Bw[:, 10:10 + m], alpha=-0.5)
    L = np.nan_to_num(np.tril(U.T))
    ref = -0.5 * L.astype(np.float64) @ Bw.numpy()[:, 10:10 + m]
    assert torch.isfinite(got).all()
    assert_close(got.numpy(), ref, F32, 2 * n + 3, "trmm_lln views")


def test_trmm_lln_rejects_bad_arguments():
    with pytest.raises(ValueError):
        trmm_lln_f32(torch.eye(4, 5), torch.zeros(4, 2))     # not square
    with pytest.raises(ValueError):
        trmm_lln_f32(torch.eye(4), torch.zeros(5, 2))        # B rows
    with pytest.raises(ValueError):
        trmm_lln_f32(torch.eye(4).double(), torch.zeros(4, 2).double())


COMBOS = [(s, u, t, d) for s in "LR" for u in "LU" for t in "NT"
          for d in "NU"]


def kernel_route(monkeypatch):
    """Send the public trmm of a CPU f32 tensor down the card's route
    (_KernelTiles: _trmm_left_f32, the kernel's twin here)."""
    real = tblocked._tiles_for
    monkeypatch.setattr(tblocked, "_tiles_for", lambda A, *a, **k: (
        tblocked._KernelTiles() if A.dtype == torch.float32
        else real(A, *a, **k)))


@pytest.mark.parametrize("route", ["f32 torch", "f32 kernel", "f64 torch"])
@pytest.mark.parametrize("side,uplo,trans,diag", COMBOS)
def test_trmm_vs_jax(side, uplo, trans, diag, route, small_nb, monkeypatch):
    n, m = 160, 96                 # not a multiple of the leaf width
    dtype = np.float32 if route.startswith("f32") else np.float64
    if route == "f32 kernel":
        kernel_route(monkeypatch)
    A = rnd((n, n), 5, dtype) + np.eye(n, dtype=dtype)
    B = rnd((n, m) if side == "L" else (m, n), 6, dtype)
    kernels.reset_launch_counts()
    got = ct.trmm(side, uplo, trans, diag, 1.5, torch.from_numpy(A),
                  torch.from_numpy(B))
    ref = jblocked.trmm(side, uplo, trans, diag, 1.5, jnp.asarray(A),
                        jnp.asarray(B), backend="xla")
    assert got.dtype == torch.from_numpy(B).dtype
    assert_close(got.numpy(), np.asarray(ref), dtype, 3 * n + 3,
                 f"trmm {side}{uplo}{trans}{diag} {route}")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("route", ["f32 torch", "f32 kernel"])
def test_trmm_conj_trans_and_trmm2(route, monkeypatch):
    # 'C' is 'T' on real operands; trmm2 is trmm (out of place anyway)
    if route == "f32 kernel":
        kernel_route(monkeypatch)
    A = torch.from_numpy(rnd((96, 96), 7) + np.eye(96, dtype=F32))
    B = torch.from_numpy(rnd((96, 40), 8))
    want = ct.trmm("L", "U", "T", "N", 0.5, A, B)
    torch.testing.assert_close(ct.trmm("L", "U", "C", "N", 0.5, A, B), want)
    torch.testing.assert_close(ct.trmm2("L", "U", "T", "N", 0.5, A, B), want)
    ref = ct.trmm("L", "U", "T", "N", 0.5, A, B, backend="ref")
    assert_close(want.numpy(), ref.numpy(), F32, 3 * 96 + 3, "trmm ref")


@pytest.mark.parametrize("route", ["f32 torch", "f32 kernel", "f64 torch"])
def test_trmm_reads_only_the_selected_triangle(route, monkeypatch):
    if route == "f32 kernel":
        kernel_route(monkeypatch)
    dtype = np.float32 if route.startswith("f32") else np.float64
    n = 160
    A = rnd((n, n), 9, dtype) + np.eye(n, dtype=dtype)
    A[np.triu_indices(n, 1)] = np.nan
    B = torch.from_numpy(rnd((n, n), 10, dtype))
    for side, trans in (("L", "N"), ("R", "T")):
        C = ct.trmm(side, "L", trans, "N", 1.0, torch.from_numpy(A), B)
        assert torch.isfinite(C).all()


# one combination per canonical form: left lower, left upper (reversed),
# right lower and right upper
@pytest.mark.parametrize("side,uplo,trans,diag", [
    ("L", "L", "N", "N"), ("L", "U", "N", "U"), ("R", "L", "N", "N"),
    ("R", "U", "T", "N")])
def test_dtrmm_vs_jax_ozaki(side, uplo, trans, diag, small_nb):
    # the d route on the card: the hoisted-peel live-block recursion of
    # _OzakiTiles.trmm_lln, here over the Ozaki kernels' twins
    n, m = 200, 72
    A = rnd((n, n), 11, np.float64) + np.eye(n)
    B = rnd((n, m) if side == "L" else (m, n), 12, np.float64)
    got = ct.dtrmm(side, uplo, trans, diag, 0.75, torch.from_numpy(A),
                   torch.from_numpy(B), backend="ozaki")
    ref = jblocked.trmm(side, uplo, trans, diag, 0.75, jnp.asarray(A),
                        jnp.asarray(B), backend="ozaki")
    exact = ct.dtrmm(side, uplo, trans, diag, 0.75, torch.from_numpy(A),
                     torch.from_numpy(B), backend="ref").numpy()
    scale = np.max(np.abs(exact))
    assert np.max(np.abs(got.numpy() - exact)) < 1e-9 * scale
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) < 1e-9 * scale


def test_ozaki_trmm_lln_recursion_absorbs_the_tail(small_nb, monkeypatch):
    # n = 200 with nb = 64: leaves 64, 64 and a 72-row tail (<= 1.5·nb),
    # the ragged-tail absorption of JAX blocked.py:483-485
    t = tblocked._OzakiTiles()
    calls = []
    real = tblocked.ozaki.matmul_presplit

    def spy(As, asc, Bs, bsc, **update):
        calls.append((As.shape[1], As.shape[2]))
        return real(As, asc, Bs, bsc, **update)

    monkeypatch.setattr(tblocked.ozaki, "matmul_presplit", spy)
    L = torch.from_numpy(np.tril(rnd((200, 200), 13, np.float64)))
    B = torch.from_numpy(rnd((200, 30), 14, np.float64))
    C = t.trmm_lln(L, B, 64)
    assert sorted(calls) == sorted([(64, 64), (64, 64), (72, 72), (72, 128),
                                    (64, 64)])
    ref = L.numpy() @ B.numpy()
    assert np.max(np.abs(C.numpy() - ref)) < 1e-9 * np.max(np.abs(ref))
