"""The distributed GP train step of the port (cholesky_tpu_torch.models.
gp_dist.make_gp_train_step on a (dp, mp) = (2, 2) process mesh of
``launch.mesh2d``) against the JAX package's (cholesky_tpu.models.gp_dist
on a 2 × 2 CPU mesh), and the dry run (cholesky_tpu_torch.entry).

One world of four spawned gloo ranks for the whole module runs every
case's rank side (tests/torch_dist_ranks.py, which imports no JAX) at the
dry run's shapes (n_train 64, 3 features, batch 4, nb 8, 2 probes), on
the same numpy X, y and Rademacher probes that JAX's step is given, from
the same parameters. (params', mean nll, infos) agree with JAX's within a
relative 1e-4 in f32 (the port runs the kernels' twins, JAX its Pallas
kernels in interpret mode) and 1e-10 in f64 (both take the oracle tiles);
the parameters' gradients, read back as (params − params')/lr, within
the same relative bound of their largest. Every rank returns the same
bits; world 1 agrees with world 4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cholesky_tpu.models.gp import GPParams as JGPParams
from cholesky_tpu.models.gp_dist import make_gp_train_step as jax_make_step
from cholesky_tpu_torch import entry
from cholesky_tpu_torch.models import make_gp_train_step
from cholesky_tpu_torch.parallel import launch
from tests import torch_dist_ranks as ranks

DP = MP = 2
BATCH = 2 * DP
NB, LR = entry.NB, 1e-2
RTOL = {"f32": 1e-4, "f64": 1e-10}
DTYPES = {"f32": np.float32, "f64": np.float64}
NAN_AT = (1, 20)        # batch member 1, feature row 20: K's row/col 20


def inputs(dt, nan=False):
    X, y, probes = (a.astype(DTYPES[dt]) for a in entry.dryrun_data(BATCH))
    if nan:
        X[NAN_AT[0], NAN_AT[1], 1] = np.nan
    return X, y, probes


def params0(dt):
    return tuple(np.asarray(v) for v in JGPParams.init(jnp.dtype(DTYPES[dt])))


def step_case(dt, nan=False, dp=DP, mp=MP):
    X, y, probes = inputs(dt, nan)
    return ("gp_step", dict(X=X, y=y, probes=probes, params=params0(dt),
                            dp=dp, mp=mp, nb=NB, lr=LR))


CASES = {"f32": step_case("f32"), "f64": step_case("f64"),
         "nan_f32": step_case("f32", nan=True),
         "nan_f64": step_case("f64", nan=True)}


@pytest.fixture(scope="module")
def world():
    """Every case on every rank of one world of DP·MP gloo ranks."""
    return launch.spawn(DP * MP, ranks.run, CASES, timeout=300.0)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:DP * MP]).reshape(DP, MP),
                ("dp", "mp"))


@functools.lru_cache(maxsize=None)
def jax_step(name, mesh):
    """JAX's (params', mean nll, infos) of CASES[name], as numpy."""
    kw = CASES[name][1]
    X = kw["X"]
    step = jax_make_step(mesh, X.shape[1], X.shape[2], BATCH, nb=NB,
                         n_probes=kw["probes"].shape[2], lr=LR,
                         dtype=jnp.dtype(X.dtype))
    new, nll, info = step(JGPParams(*map(jnp.asarray, kw["params"])),
                          jnp.asarray(X), jnp.asarray(kw["y"]),
                          jnp.asarray(kw["probes"]))
    return (np.array([float(p) for p in new]), float(nll),
            np.asarray(info))


def grads(name, new):
    return (np.array(CASES[name][1]["params"], np.float64) - new) / LR


def assert_step_close(got, ref, name, rtol):
    params, nll, infos = ref
    np.testing.assert_array_equal(got["infos"], infos)
    np.testing.assert_allclose(float(got["nll"]), nll, rtol=rtol)
    np.testing.assert_allclose(got["params"], params, rtol=rtol)
    g, g_ref = grads(name, got["params"]), grads(name, params)
    assert np.max(np.abs(g - g_ref)) <= rtol * np.max(np.abs(g_ref)), \
        (g, g_ref)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_gp_step_vs_jax(world, mesh, dt):
    got = world[0][dt]
    assert got["params"].dtype == DTYPES[dt]
    assert (got["infos"] == 0).all() and np.isfinite(got["nll"])
    assert_step_close(got, jax_step(dt, mesh), dt, RTOL[dt])


@pytest.mark.parametrize("name", list(CASES))
def test_step_identical_on_every_rank(world, name):
    for key in ("params", "nll", "infos"):
        v = np.asarray(world[0][name][key])
        for r in range(1, DP * MP):
            w = np.asarray(world[r][name][key])
            assert v.tobytes() == w.tobytes(), (name, key, r)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_world_of_one_matches_world_four(world, dt):
    # no process group in this process: mesh2d(1, 1) is a world of one,
    # which takes the whole batch
    one = ranks.run(0, {dt: step_case(dt, dp=1, mp=1)})[dt]
    four = world[0][dt]
    assert_step_close(one, (four["params"], float(four["nll"]),
                            four["infos"]), dt, RTOL[dt])


def test_mesh2d_layout_vs_jax(world, mesh):
    # rank = i_dp·mp + i_mp, JAX's reshape(dp, mp) of the device list;
    # the mp group is the rank's row, the dp group its column
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r in range(DP * MP):
        got = world[r]["f32"]
        i_dp, i_mp = got["coords"]
        assert ids[i_dp, i_mp] == r
        assert got["mp_ranks"] == list(ids[i_dp, :])
        assert got["dp_ranks"] == list(ids[:, i_mp])


def step_counts(nblk, local_batch):
    """One step's collectives on a rank: for each local problem potrf_dist
    (nblk broadcasts, nblk − 1 all_gathers), the log-determinant (one
    all_reduce) and the two solves (N: nblk broadcasts and nblk − 1
    all_reduces; T: 2·nblk − 1 broadcasts); then one all_reduce and one
    all_gather over the dp group."""
    return {"broadcast": local_batch * (4 * nblk - 1),
            "all_reduce": local_batch * nblk + 1,
            "all_gather": local_batch * (nblk - 1) + 1}


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_census_per_step(world, name):
    nblk = 64 // NB                    # n_train 64 pads to nb·mp = 16: 64
    for r in range(DP * MP):
        assert world[r][name]["counts"] == step_counts(nblk, BATCH // DP)


def test_census_world_of_one():
    got = ranks.run(0, {"one": step_case("f32", dp=1, mp=1)})["one"]
    assert got["counts"] == step_counts(64 // NB, BATCH)


def test_nan_row_f32_info_as_jax(world, mesh):
    # the NaN row stops that problem's factor at its first NaN pivot on
    # both ranks of its mp group; every rank still reaches the dp
    # reduction (the world returned), and the infos are JAX's
    got = world[0]["nan_f32"]
    params, nll, infos = jax_step("nan_f32", mesh)
    want = np.zeros(BATCH, np.int32)
    want[NAN_AT[0]] = NAN_AT[1] + 1
    np.testing.assert_array_equal(infos, want)
    np.testing.assert_array_equal(got["infos"], want)
    assert np.isnan(float(got["nll"])) and np.isnan(nll)
    # the failed group stopped early; the other ran every step
    short = [world[r]["nan_f32"]["counts"] for r in range(DP * MP)]
    full = step_counts(64 // NB, BATCH // DP)
    assert short[2] == short[3] == full
    assert short[0] == short[1] != full


def test_nan_row_f64_info_is_lapacks(world, mesh):
    # f64 runs the oracle leaves on both sides: the port reports the first
    # NaN pivot, as LAPACK does; JAX's oracle potf2 multiplies the NaN
    # row by masked zeros, which spreads it to earlier pivots of the block
    # (ROADMAP Queue 3, Known differences)
    got = world[0]["nan_f64"]
    _, _, infos = jax_step("nan_f64", mesh)
    k = NAN_AT[1] + 1
    assert got["infos"][NAN_AT[0]] == k
    assert (k - 1) // NB * NB < infos[NAN_AT[0]] <= k
    mask = np.arange(BATCH) != NAN_AT[0]
    assert (got["infos"][mask] == 0).all() and (infos[mask] == 0).all()


def test_dryrun_multichip_cpu(capsys):
    entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh dp=2 mp=2 (gloo), nll=" in out


def test_dryrun_multichip_needs_a_card_a_rank():
    # NCCL takes one rank a card, and the run never moves to the CPU
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 cards"):
        entry.dryrun_multichip(2)


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (3, (1, 3)),
                                     (4, (2, 2)), (8, (2, 4))])
def test_mesh_shape_as_jax(n, shape):
    assert entry.mesh_shape(n) == shape


def test_entry_forward_cpu(capsys):
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in (*args[0], *args[1:]))
    nll = float(fn(*args))
    assert np.isfinite(nll)
    assert entry.main(["--device", "cpu"]) == 0
    assert f"entry ok: gp_nll n=256 d=4 on cpu: {nll:.4f}" in \
        capsys.readouterr().out


def test_mesh2d_world_of_one_and_bad_shapes():
    m = launch.mesh2d(1, 1)
    assert (m.dp, m.mp, m.i_dp, m.i_mp) == (1, 1, 0, 0)
    assert m.dp_group is None and m.mp_group is None
    for dp, mp in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="does not match"):
            launch.mesh2d(dp, mp)


def test_step_rejects_a_batch_dp_does_not_divide():
    mesh = launch.Mesh2D(dp=3, mp=1, i_dp=0, i_mp=0)
    with pytest.raises(ValueError):
        make_gp_train_step(mesh, 64, 3, 4)
