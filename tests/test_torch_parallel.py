"""The block-cyclic tier of the port (cholesky_tpu_torch.parallel:
distribute/collect, potrf/logdet, trsm) against the JAX package's
(cholesky_tpu.parallel) on the same numpy inputs.

The port runs at world 4 over gloo: one world of four spawned ranks for
the whole module (``launch.spawn``), which runs every case's rank side
(tests/torch_dist_ranks.py, which imports no JAX) and returns numpy
arrays. The JAX package runs on a 4-device CPU mesh with tiles="ref" (no
Pallas in interpret mode), the same nb, phases and lookahead; the port
runs both tiles="ref" and "auto" (on the CPU: the kernels' twins).

Bounds are tests/util.assert_close's eps-scaled ones: 8n for a factor,
60n for a triangular solve; logdet within n·eps relative. ``info``
matches exactly; the block-cyclic shards match bit for bit; every
replicated output is bit-identical on every rank. On a non-positive-
definite input only the leading (info − 1) block is compared (ROADMAP
Queue 3, "Garbage past a failed pivot").

The collective census (the port's form of tests/test_parallel_hlo.py)
reads the counts of ``parallel.comm`` per call."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cholesky_tpu.parallel import blockcyclic as jbc
from cholesky_tpu.parallel import potrf as jpotrf
from cholesky_tpu.parallel import trsm as jtrsm
from cholesky_tpu_torch.parallel import comm, launch
from tests import torch_dist_ranks as ranks
from tests.util import assert_close

P = 4
N, NB = 333, 32
NBLK = -(-N // (NB * P)) * P          # 12 blocks of 32 rows, npad 384
DTYPES = {"f32": np.float32, "f64": np.float64, "c64": np.complex64}
EPS32 = float(np.finfo(np.float32).eps)


def spd_np(n, dtype=np.float32, cond=50.0, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    if np.iscomplexobj(np.zeros((), dtype)):
        G = G + 1j * rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(G)
    A = (Q * np.linspace(1.0, cond, n)) @ Q.conj().T
    return np.ascontiguousarray(0.5 * (A + A.conj().T), dtype)


def nonpd_np(seed=3):
    A = spd_np(N, seed=seed)
    A[100, 100] = -2.0
    return A


INPUTS = {name: spd_np(N, dt, seed=1) for name, dt in DTYPES.items()}
A32 = INPUTS["f32"]
NONPD = nonpd_np()
RHS = np.random.default_rng(5).standard_normal((N, 3)).astype(np.float32)
RHS_C = (RHS + 1j * RHS[::-1]).astype(np.complex64)
LAYOUT = np.random.default_rng(6).standard_normal((N, N)).astype(np.float32)

CASES = {
    "layout": ("layout", dict(A=LAYOUT, nb=NB)),
    "layout_nopad": ("layout", dict(A=LAYOUT, nb=NB, pad_identity=False)),
    **{f"potrf_{d}_{tiles}": ("potrf_sharded",
                              dict(A=INPUTS[d], nb=NB, tiles=tiles))
       for d in DTYPES for tiles in ("ref", "auto")},
    "potrf_f64_fast": ("potrf_sharded",
                       dict(A=INPUTS["f64"], nb=NB, tiles="fast")),
    "potrf_upper": ("potrf_sharded", dict(A=A32, uplo="U", nb=NB)),
    **{f"nonpd_{la}_{tiles}": ("potrf_sharded",
                               dict(A=NONPD, nb=NB, tiles=tiles,
                                    lookahead=la == "la"))
       for la in ("la", "serial") for tiles in ("ref", "auto")},
    **{f"phases_{k}": ("potrf_sharded", dict(A=A32, nb=NB, phases=k))
       for k in (1, 3, 4)},
    "serial": ("potrf_sharded", dict(A=A32, nb=NB, lookahead=False)),
    "dist": ("potrf_dist", dict(A=A32, nb=NB)),
    "dist_serial": ("potrf_dist", dict(A=A32, nb=NB, lookahead=False)),
    "logdet": ("logdet_dist", dict(A=A32, nb=NB)),
    "logdet_sharded": ("logdet_sharded", dict(A=A32, nb=NB)),
    "solve_N": ("solve", dict(A=A32, B=RHS, nb=NB, trans="N")),
    "solve_T": ("solve", dict(A=A32, B=RHS, nb=NB, trans="T")),
    "solve_vec": ("solve", dict(A=A32, B=RHS[:, 0].copy(), nb=NB,
                                trans="N")),
    "solve_C": ("solve", dict(A=INPUTS["c64"], B=RHS_C, nb=NB, trans="C")),
}


@pytest.fixture(scope="module")
def world():
    """Every case on every rank of one world of P gloo ranks."""
    return launch.spawn(P, ranks.run, CASES, timeout=600.0)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:P]), ("d",))


# --- the JAX side, each call once per module ------------------------------
# (an eager JAX call compiles its shard_map anew, most of this file's time:
# one factor of each input serves every case that factors it as is)

@functools.lru_cache(maxsize=None)
def jax_potrf(key, mesh, **kw):
    A = {"nonpd": NONPD, **INPUTS}[key]
    F, info = jpotrf.potrf_sharded("L", jnp.asarray(A), mesh, nb=NB,
                                   tiles="ref", **kw)
    return np.asarray(F), int(info)


@functools.lru_cache(maxsize=None)
def jax_factor(key, mesh):
    """JAX's potrf_dist of INPUTS[key] at the defaults: (fbc, info)."""
    fbc, info = jpotrf.potrf_dist(
        jbc.distribute(jnp.asarray(INPUTS[key]), mesh, nb=NB), tiles="ref")
    return fbc, int(info)


def jax_lower(key, mesh):
    """JAX's potrf_sharded("L", INPUTS[key]) on the lower triangle: the
    collected potrf_dist factor, which is all potrf_sharded adds to it."""
    fbc, info = jax_factor(key, mesh)
    return np.tril(np.asarray(jbc.collect(fbc))), info


def case(world, name, rank=0):
    return world[rank][name]


# --- layout -----------------------------------------------------------------

@pytest.mark.parametrize("name,pad", [("layout", True),
                                      ("layout_nopad", False)])
def test_layout_bit_for_bit_with_jax_shards(world, mesh, name, pad):
    bc = jbc.distribute(jnp.asarray(LAYOUT), mesh, nb=NB, pad_identity=pad)
    shards = {s.device.id: np.asarray(s.data)
              for s in bc.local.addressable_shards}
    assert len(shards) == P
    for r in range(P):
        mine = case(world, name, r)["local"]
        assert mine.shape == shards[r].shape == (NBLK // P, NB, NBLK * NB)
        np.testing.assert_array_equal(mine, shards[r])


@pytest.mark.parametrize("name", ["layout", "layout_nopad"])
def test_roundtrip_on_every_rank(world, name):
    for r in range(P):
        np.testing.assert_array_equal(case(world, name, r)["back"], LAYOUT)


# --- potrf ------------------------------------------------------------------

@pytest.mark.parametrize("tiles", ["ref", "auto"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_potrf_sharded_vs_jax(world, mesh, dtype, tiles):
    got = case(world, f"potrf_{dtype}_{tiles}")
    F, info = jax_lower(dtype, mesh)
    assert int(got["info"]) == info == 0
    assert got["F"].dtype == DTYPES[dtype]
    assert_close(np.tril(got["F"]), np.tril(F), DTYPES[dtype], 8 * N,
                 f"potrf_sharded {dtype} {tiles}")
    # the strict upper is the caller's
    np.testing.assert_array_equal(np.triu(got["F"], 1),
                                  np.triu(INPUTS[dtype], 1))


def test_potrf_f64_fast_tiles_vs_jax(world, mesh):
    # tiles='fast' puts f64 on the d tier (the Ozaki twins here), as the
    # JAX test_potrf_dist_fast_f64_tiles does; its bound is that test's
    got = case(world, "potrf_f64_fast")
    F, info = jax_lower("f64", mesh)
    assert int(got["info"]) == info == 0
    diff = np.max(np.abs(np.tril(got["F"]) - np.tril(F)))
    assert diff < 1e-9, diff


def test_potrf_upper_vs_jax(world, mesh):
    # JAX's upper route factors Aᴴ, which is A32 bit for bit, and returns
    # the factor's transpose
    got = case(world, "potrf_upper")
    np.testing.assert_array_equal(A32, A32.T)
    F, info = jax_lower("f32", mesh)
    assert int(got["info"]) == info == 0
    assert_close(np.triu(got["F"]), F.T, np.float32, 8 * N,
                 "potrf_sharded upper")
    np.testing.assert_array_equal(np.tril(got["F"], -1), np.tril(A32, -1))


@pytest.mark.parametrize("tiles", ["ref", "auto"])
@pytest.mark.parametrize("la", ["la", "serial"])
def test_potrf_nonpd_info_vs_jax(world, mesh, la, tiles):
    got = case(world, f"nonpd_{la}_{tiles}")
    F, info = jax_potrf("nonpd", mesh, lookahead=la == "la")
    assert 1 <= info <= 101
    assert int(got["info"]) == info
    assert np.isfinite(got["F"]).all()
    k = info - 1
    assert_close(np.tril(got["F"][:k, :k]), np.tril(F[:k, :k]), np.float32,
                 8 * N, f"leading block, {la} {tiles}")


@pytest.mark.parametrize("phases", [1, 3])
def test_potrf_phases_vs_jax(world, mesh, phases):
    # one JAX run at phases=1, whose windows differ most from the default
    # 4: the port's phases are a no-op (test_potrf_phases_change_nothing)
    got = case(world, f"phases_{phases}")
    F, info = jax_potrf("f32", mesh, phases=1)
    assert int(got["info"]) == info == 0
    assert_close(np.tril(got["F"]), np.tril(F), np.float32, 8 * N,
                 f"phases={phases}")


def test_potrf_phases_change_nothing(world):
    # the eager loop's live windows make `phases` a no-op: bit for bit
    F = case(world, "phases_4")["F"]
    for k in (1, 3):
        np.testing.assert_array_equal(case(world, f"phases_{k}")["F"], F)


def test_potrf_lookahead_vs_serial(world, mesh):
    la, serial = case(world, "phases_4"), case(world, "serial")
    F, info = jax_potrf("f32", mesh, lookahead=False)
    assert int(serial["info"]) == info == 0
    assert_close(np.tril(serial["F"]), np.tril(F), np.float32, 8 * N,
                 "serial vs JAX serial")
    assert_close(np.tril(la["F"]), np.tril(serial["F"]), np.float32, 8 * N,
                 "lookahead vs serial")


def test_potrf_dist_vs_jax(world, mesh):
    got = case(world, "dist")
    F, info = jax_lower("f32", mesh)
    assert int(got["info"]) == info == 0
    assert_close(np.tril(got["F"]), np.tril(F), np.float32, 8 * N,
                 "potrf_dist")


# --- logdet -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_logdet(mesh):
    val, info = jpotrf.logdet_dist(
        jbc.distribute(jnp.asarray(A32), mesh, nb=NB), tiles="ref")
    return float(val), int(info)


@pytest.mark.parametrize("name", ["logdet", "logdet_sharded"])
def test_logdet_vs_jax(world, mesh, name):
    got = case(world, name)
    val, info = jax_logdet(mesh)
    assert int(got["info"]) == info == 0
    rel = abs(float(got["val"]) - val) / abs(val)
    assert rel <= N * EPS32, rel
    ref = np.linalg.slogdet(A32.astype(np.float64))[1]
    assert abs(float(got["val"]) - ref) / abs(ref) <= N * EPS32


# --- trsm through the factor ------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_solve(name, mesh):
    kw = CASES[name][1]
    fbc, _ = jax_factor("c64" if kw["A"] is INPUTS["c64"] else "f32", mesh)
    return np.asarray(jtrsm.trsm_factor_dist(fbc, jnp.asarray(kw["B"]),
                                             trans=kw["trans"]))


@pytest.mark.parametrize("name", ["solve_N", "solve_T", "solve_vec",
                                  "solve_C"])
def test_trsm_factor_dist_vs_jax(world, mesh, name):
    got = case(world, name)
    X = jax_solve(name, mesh)
    assert int(got["info"]) == 0
    assert got["X"].shape == X.shape == CASES[name][1]["B"].shape
    assert_close(got["X"], X, X.dtype, 60 * N, name)


def test_solve_through_the_factor(world):
    # L·z = b against numpy's factor, on the port alone
    L = np.linalg.cholesky(A32.astype(np.float64))
    z = np.linalg.solve(L, RHS.astype(np.float64))
    assert_close(case(world, "solve_N")["X"], z, np.float32, 60 * N,
                 "forward solve vs numpy")


# --- every replicated output, bit-identical on every rank ------------------

@pytest.mark.parametrize("name", list(CASES))
def test_replicated_outputs_identical_on_every_rank(world, name):
    for key, v in case(world, name).items():
        if key in ("local", "counts"):
            continue
        for r in range(1, P):
            w = case(world, name, r)[key]
            assert np.asarray(v).tobytes() == np.asarray(w).tobytes(), \
                f"{name}[{key}] differs between rank 0 and rank {r}"


def test_world_of_one_matches_world_four(world):
    # no process group in this process: group=None is a world of one
    got = ranks.run(0, {"one": CASES["potrf_f32_auto"]})["one"]
    assert int(got["info"]) == 0
    F4 = case(world, "potrf_f32_auto")["F"]
    assert_close(np.tril(got["F"]), np.tril(F4), np.float32, 8 * N,
                 "world 1 vs world 4")


# --- the collective census ---------------------------------------------------

def potrf_counts(nblk):
    """potrf: one diagonal broadcast per step (the block-0 prologue with
    lookahead, the top of each step without), one panel all_gather per
    step but the last."""
    return {"broadcast": nblk, "all_reduce": 0, "all_gather": nblk - 1}


def trsm_counts(nblk, trans):
    """Forward: a diagonal broadcast per step and an all_reduce per step
    but the last; backward: a diagonal broadcast per step and the owner's
    update broadcast per step but the last."""
    if trans == "N":
        return {"broadcast": nblk, "all_reduce": nblk - 1, "all_gather": 0}
    return {"broadcast": 2 * nblk - 1, "all_reduce": 0, "all_gather": 0}


@pytest.mark.parametrize("name", ["dist", "dist_serial"])
def test_census_potrf(world, name):
    for r in range(P):
        assert case(world, name, r)["counts"] == potrf_counts(NBLK)


def test_census_logdet_is_potrf_plus_one_all_reduce(world):
    want = potrf_counts(NBLK)
    want["all_reduce"] += 1
    assert case(world, "logdet")["counts"] == want


@pytest.mark.parametrize("name,trans", [("solve_N", "N"), ("solve_T", "T"),
                                        ("solve_C", "C")])
def test_census_trsm(world, name, trans):
    assert case(world, name)["counts"] == trsm_counts(NBLK, trans)


def test_census_collect_is_one_all_gather(world):
    assert case(world, "layout")["counts"] == {
        "broadcast": 0, "all_reduce": 0, "all_gather": 1}


def census_world_of_one(n, nb=16):
    A = spd_np(n, seed=2)
    B = RHS[:n].copy()
    got = ranks.run(0, {
        "dist": ("potrf_dist", dict(A=A, nb=nb)),
        "logdet": ("logdet_dist", dict(A=A, nb=nb)),
        "N": ("solve", dict(A=A, B=B, nb=nb, trans="N")),
        "T": ("solve", dict(A=A, B=B, nb=nb, trans="T")),
    })
    return {k: v["counts"] for k, v in got.items()}


def test_census_linear_in_nblk():
    # nblk = 4, 8, 16 (world of one, nb = 16): the exact counts, and each
    # count's growth from 8 to 16 blocks twice that from 4 to 8
    runs = {nblk: census_world_of_one(16 * nblk) for nblk in (4, 8, 16)}
    for nblk, c in runs.items():
        assert c["dist"] == potrf_counts(nblk)
        assert c["logdet"] == {**potrf_counts(nblk), "all_reduce": 1}
        assert c["N"] == trsm_counts(nblk, "N")
        assert c["T"] == trsm_counts(nblk, "T")
    for call in ("dist", "logdet", "N", "T"):
        for kind in comm.COUNTS:
            a, b, c = (runs[k][call][kind] for k in (4, 8, 16))
            assert c - b == 2 * (b - a), (call, kind, a, b, c)


def test_world_of_one_collectives_return_their_input():
    x = torch.ones(3)
    assert comm.world() == 1 and comm.rank() == 0
    assert comm.all_gather(x)[0] is x
    assert comm.broadcast(x, 0) is x and comm.all_reduce(x) is x


def test_init_single_gloo_group_matches_world_of_one():
    # a one-rank gloo group made by init_single runs the real collectives
    # and gives the world of one's factor bit for bit
    import torch.distributed as dist
    want = ranks.run(0, {"one": CASES["potrf_f32_auto"]})["one"]
    launch.init_single("cpu")
    try:
        got = ranks.run(0, {"one": CASES["potrf_f32_auto"]})["one"]
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got["F"], want["F"])
    assert got["counts"] == want["counts"]


@pytest.mark.parametrize("backend", ["gloo", "cpu:gloo"])
def test_cpu_tensor_needs_gloo_for_its_device_type(backend):
    # a group named by device type ("cuda:nccl,cpu:gloo", what
    # init_process_group picks on a machine with a card) takes the
    # backend of the tensor's device
    import torch.distributed as dist
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        x = torch.arange(3.0)
        assert comm.broadcast(x, 0) is x and comm.all_reduce(x) is x
        assert comm.all_gather(x)[0].tolist() == [0.0, 1.0, 2.0]
    finally:
        dist.destroy_process_group()
