"""The port's entry points for a first run: the single-device GP forward
and the distributed GP train step's dry run.

The counterpart of ``__graft_entry__.py:71-166``:

    python -m cholesky_tpu_torch.entry                       # entry()'s nll
    python -m cholesky_tpu_torch.entry --dryrun N            # N cards, NCCL
    python -m cholesky_tpu_torch.entry --dryrun N --device cpu   # N gloo ranks

On the card the dry run takes one NCCL rank a visible card and raises if
there are fewer than N: NCCL refuses two ranks on one card, and the run
never moves to the CPU by itself. With ``--device cpu`` it spawns a world
of N gloo ranks, the analogue of JAX's self-provisioned CPU mesh.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from cholesky_tpu_torch.models.gp import GPParams, gp_nll
from cholesky_tpu_torch.models.gp_dist import make_gp_train_step
from cholesky_tpu_torch.parallel import launch

#: the dry run's shapes (``__graft_entry__.py:145``): the batch is 2·dp
N_TRAIN, N_FEATURES, NB, N_PROBES = 64, 3, 8, 2


def entry(device="cuda"):
    """(fn, args): fn(params, X, y) is the GP negative log marginal
    likelihood at n = 256, d = 4 on random data from seed 0."""
    n, d = 256, 4
    g = torch.Generator(device="cpu").manual_seed(0)
    X = torch.randn(n, d, generator=g)
    y = torch.sin(X[:, 0]) + 0.1 * torch.randn(n, generator=g)
    params = GPParams.init(device=device)

    def fn(params, X, y):
        nll, info = gp_nll(params, X, y)
        return nll

    return fn, (params, X.to(device), y.to(device))


def mesh_shape(n_devices: int) -> tuple:
    """(dp, mp) of the dry run on n devices, as the JAX package splits
    them: dp = 2 where n is even, else 1."""
    dp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return dp, n_devices // dp


def dryrun_data(batch: int, seed: int = 0):
    """The dry run's X, y and Rademacher probes of the whole batch, f32
    numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((batch, N_TRAIN, N_FEATURES)).astype(np.float32)
    y = (np.sin(X[..., 0]) + 0.1 * rng.standard_normal(
        (batch, N_TRAIN))).astype(np.float32)
    probes = rng.choice(np.array([-1.0, 1.0], np.float32),
                        (batch, N_TRAIN, N_PROBES))
    return X, y, probes


def _dryrun_rank(rank, dp, mp, device):
    """One rank of the dry run: its dp shard of the batch through one
    train step; returns (params', nll, infos) as Python numbers."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    mesh = launch.mesh2d(dp, mp)
    batch = 2 * dp
    step = make_gp_train_step(mesh, N_TRAIN, N_FEATURES, batch, nb=NB,
                              n_probes=N_PROBES)
    rows = slice(mesh.i_dp * batch // dp, (mesh.i_dp + 1) * batch // dp)
    X, y, probes = (torch.from_numpy(a[rows]).to(dev)
                    for a in dryrun_data(batch))
    params, nll, infos = step(GPParams.init(device=dev), X, y, probes)
    return ([float(p) for p in params], float(nll),
            [int(i) for i in infos.cpu()])


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One distributed train step on a (dp, mp) mesh of ``n_devices``
    ranks (:func:`mesh_shape`) at the JAX dry run's shapes, with its
    checks: a finite nll, every info 0, finite parameters, the same on
    every rank. Prints the ``dryrun_multichip ok`` line."""
    dp, mp = mesh_shape(n_devices)
    device = torch.device(device).type
    if device == "cuda":
        have = torch.cuda.device_count()
        if n_devices > have:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} NCCL ranks need "
                f"{n_devices} cards, torch sees {have}")
        backend = "nccl"
    else:
        backend = "gloo"
    out = launch.spawn(n_devices, _dryrun_rank, dp, mp, device,
                       backend=backend, timeout=600.0)
    params, nll, infos = out[0]
    if any(o != out[0] for o in out[1:]):
        raise RuntimeError(f"dryrun_multichip: the ranks disagree: {out}")
    if not math.isfinite(nll):
        raise RuntimeError(f"dryrun_multichip: non-finite NLL {nll}")
    if any(infos):
        raise RuntimeError(f"dryrun_multichip: potrf info != 0: {infos}")
    if not all(map(math.isfinite, params)):
        raise RuntimeError(f"dryrun_multichip: non-finite params {params}")
    print(f"dryrun_multichip ok: mesh dp={dp} mp={mp} ({backend}), "
          f"nll={nll:.4f}, params={params}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="one distributed train step on N ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    fn, fargs = entry(args.device)
    nll = float(fn(*fargs))
    if not math.isfinite(nll):
        raise RuntimeError(f"entry: non-finite NLL {nll}")
    print(f"entry ok: gp_nll n=256 d=4 on {args.device}: {nll:.4f}")
    return 0


if __name__ == "__main__":
    import sys

    from cholesky_tpu_torch.entry import main as _main
    sys.exit(_main())
