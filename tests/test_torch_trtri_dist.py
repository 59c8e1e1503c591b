"""The distributed trtri / lauum / potri of the port
(cholesky_tpu_torch.parallel.trtri) against the JAX package's
(cholesky_tpu.parallel.trtri) on the same numpy inputs, as
tests/test_torch_parallel.py holds potrf: one world of four gloo ranks
for the module, the JAX package on a 4-device CPU mesh with tiles="ref",
the port with tiles="ref" and "auto" (the kernels' twins on the CPU).

Bounds are tests/util.assert_close's, with the JAX package's own fpe for
each routine (tests/test_trtri_dist.py): 60n for a triangular inverse,
2n+3 for lauum (a product of depth n), 3000n for potri."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from cholesky_tpu.parallel import blockcyclic as jbc
from cholesky_tpu.parallel import potrf as jpotrf
from cholesky_tpu.parallel import trtri as jtrtri
from cholesky_tpu_torch.parallel import launch
from tests import torch_dist_ranks as ranks
from tests.util import assert_close

P = 4
N, NB = 333, 32
NBLK = -(-N // (NB * P)) * P          # 12 blocks of 32 rows


def tri_np(n, seed=0):
    """A well-conditioned lower triangle (diagonal in [1, 2])."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.uniform(-1.0, 1.0, (n, n))) / np.sqrt(n)
    L[np.diag_indices(n)] = rng.uniform(1.0, 2.0, n)
    return L.astype(np.float32)


def spd_np(n, cond=30.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.linspace(1.0, cond, n)) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32)


L32 = tri_np(N)
SINGULAR = L32.copy()
SINGULAR[37, 37] = 0.0
A32 = spd_np(N, seed=3)
# a Cholesky factor with the caller's garbage above it
F32 = (np.linalg.cholesky(A32.astype(np.float64))
       + np.triu(np.random.default_rng(4).standard_normal((N, N)), 1)
       ).astype(np.float32)

CASES = {
    **{f"trtri_{tiles}": ("trtri_dist", dict(L=L32, nb=NB, tiles=tiles))
       for tiles in ("ref", "auto")},
    **{f"singular_{tiles}": ("trtri_dist",
                             dict(L=SINGULAR, nb=NB, tiles=tiles))
       for tiles in ("ref", "auto")},
    "lauum": ("lauum_dist", dict(L=L32, nb=NB)),
    "potri_dist": ("potri_dist", dict(A=A32, nb=NB)),
    **{f"potri_sharded_{u}": ("potri_sharded",
                              dict(F=F32 if u == "L" else F32.T.copy(),
                                   uplo=u, nb=NB))
       for u in ("L", "U")},
}


@pytest.fixture(scope="module")
def world():
    return launch.spawn(P, ranks.run, CASES, timeout=600.0)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:P]), ("d",))


def case(world, name, rank=0):
    return world[rank][name]


@functools.lru_cache(maxsize=None)
def jax_trtri(key, mesh):
    L = {"trtri": L32, "singular": SINGULAR}[key]
    W, info = jtrtri.trtri_dist(jbc.distribute(jnp.asarray(L), mesh, nb=NB),
                                tiles="ref")
    return np.asarray(jbc.collect(W)), int(info)


@pytest.mark.parametrize("tiles", ["ref", "auto"])
def test_trtri_dist_vs_jax(world, mesh, tiles):
    got = case(world, f"trtri_{tiles}")
    W, info = jax_trtri("trtri", mesh)
    assert int(got["info"]) == info == 0
    assert_close(np.tril(got["W"]), np.tril(W), np.float32, 60 * N,
                 f"trtri_dist {tiles}")
    ref = np.linalg.inv(L32.astype(np.float64))
    assert_close(np.tril(got["W"]), np.tril(ref), np.float32, 60 * N,
                 f"trtri_dist {tiles} vs numpy")


@pytest.mark.parametrize("tiles", ["ref", "auto"])
def test_trtri_dist_singular_info_vs_jax(world, mesh, tiles):
    got = case(world, f"singular_{tiles}")
    _, info = jax_trtri("singular", mesh)
    assert int(got["info"]) == info == 38


def test_lauum_dist_vs_jax(world, mesh):
    got = case(world, "lauum")
    bc = jbc.distribute(jnp.asarray(L32), mesh, nb=NB, pad_identity=False)
    B = np.asarray(jbc.collect(jtrtri.lauum_dist(bc)))
    assert_close(np.tril(got["B"]), np.tril(B), np.float32, 2 * N + 3,
                 "lauum_dist")
    # the strict upper region passes through: zero here
    np.testing.assert_array_equal(np.triu(got["B"], 1), np.triu(B, 1))


def test_potri_dist_vs_jax(world, mesh):
    got = case(world, "potri_dist")
    fbc, info0 = jpotrf.potrf_dist(jbc.distribute(jnp.asarray(A32), mesh,
                                                  nb=NB), tiles="ref")
    out, info = jtrtri.potri_dist(fbc)
    Inv = np.asarray(jbc.collect(out))
    assert int(got["info0"]) == int(info0) == 0
    assert int(got["info"]) == int(info) == 0
    assert_close(np.tril(got["Inv"]), np.tril(Inv), np.float32, 3000 * N,
                 "potri_dist")
    full = np.tril(got["Inv"]).astype(np.float64)
    full = full + np.tril(full, -1).T
    assert np.max(np.abs(A32.astype(np.float64) @ full - np.eye(N))) < 5e-3


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potri_sharded_vs_jax(world, mesh, uplo):
    kw = CASES[f"potri_sharded_{uplo}"][1]
    got = case(world, f"potri_sharded_{uplo}")
    Inv, info = jtrtri.potri_sharded(uplo, jnp.asarray(kw["F"]), mesh, nb=NB)
    Inv = np.asarray(Inv)
    assert int(got["info"]) == int(info) == 0
    tri = np.tril if uplo == "L" else np.triu
    assert_close(tri(got["Inv"]), tri(Inv), np.float32, 3000 * N,
                 f"potri_sharded {uplo}")
    # the opposite strict triangle of the input factor is kept
    off = np.triu if uplo == "L" else np.tril
    k = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(off(got["Inv"], k), off(kw["F"], k))


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_outputs_identical_on_every_rank(world, name):
    for key, v in case(world, name).items():
        if key == "counts":
            continue
        for r in range(1, P):
            w = case(world, name, r)[key]
            assert np.asarray(v).tobytes() == np.asarray(w).tobytes(), \
                f"{name}[{key}] differs between rank 0 and rank {r}"


# --- the collective census ---------------------------------------------------

def trtri_counts(nblk):
    """Per column step j one diagonal broadcast; for j < nblk − 1 one
    all_gather and the inner forward solve over the nblk − 1 − j blocks
    past j (a broadcast each, an all_reduce each but the last): the only
    count quadratic in nblk, by the sweep's design."""
    return {"broadcast": nblk * (nblk + 1) // 2,
            "all_reduce": (nblk - 1) * (nblk - 2) // 2,
            "all_gather": nblk - 1}


LAUUM_COUNTS = {"broadcast": 0, "all_reduce": 1, "all_gather": 0}


@pytest.mark.parametrize("name", ["trtri_ref", "trtri_auto"])
def test_census_trtri(world, name):
    for r in range(P):
        assert case(world, name, r)["counts"] == trtri_counts(NBLK)


def test_census_lauum_is_one_all_reduce(world):
    assert case(world, "lauum")["counts"] == LAUUM_COUNTS


def test_census_potri_is_trtri_plus_lauum(world):
    want = trtri_counts(NBLK)
    want["all_reduce"] += 1
    assert case(world, "potri_dist")["counts"] == want


def test_census_in_nblk():
    # world of one, nb = 16, nblk = 4, 8, 16: the exact counts; only the
    # inner solve's broadcasts and all_reduces grow as nblk²
    for nblk in (4, 8, 16):
        n = 16 * nblk
        got = ranks.run(0, {
            "trtri": ("trtri_dist", dict(L=tri_np(n, seed=nblk), nb=16)),
            "lauum": ("lauum_dist", dict(L=tri_np(n, seed=nblk), nb=16)),
        })
        assert got["trtri"]["counts"] == trtri_counts(nblk)
        assert got["lauum"]["counts"] == LAUUM_COUNTS
        assert int(got["trtri"]["info"]) == 0
