"""The rank side of the multi-device tier's parity tests
(tests/test_torch_parallel.py, tests/test_torch_trtri_dist.py,
tests/test_torch_parallel_blas.py, tests/test_torch_gp_dist.py).

The ranks of a world started by ``cholesky_tpu_torch.parallel.launch.spawn``
import this module by name, so it imports neither JAX nor
tests/conftest.py or tests/util.py (which import JAX). Every case takes
numpy inputs and returns numpy outputs, with the collective counts of its
call (``comm.counts()``) under "counts".
"""

import numpy as np
import torch
import torch.distributed as dist

from cholesky_tpu_torch import parallel as par
from cholesky_tpu_torch.models import gp, gp_dist
from cholesky_tpu_torch.parallel import comm, launch


def _t(x):
    return torch.from_numpy(x)


def _counted(fn, *args, **kw):
    comm.reset_counts()
    out = fn(*args, **kw)
    return out, comm.counts()


def layout(A, nb, pad_identity=True):
    bc = par.distribute(_t(A), nb=nb, pad_identity=pad_identity)
    back, counts = _counted(par.collect, bc)
    return {"local": bc.local, "back": back, "counts": counts}


def potrf_sharded(A, uplo="L", **kw):
    (F, info), counts = _counted(par.potrf_sharded, uplo, _t(A), **kw)
    return {"F": F, "info": info, "counts": counts}


def potrf_dist(A, nb, **kw):
    (fbc, info), counts = _counted(par.potrf_dist,
                                   par.distribute(_t(A), nb=nb), **kw)
    return {"F": par.collect(fbc), "info": info, "counts": counts}


def logdet_dist(A, nb):
    (val, info), counts = _counted(par.logdet_dist,
                                   par.distribute(_t(A), nb=nb))
    return {"val": val, "info": info, "counts": counts}


def logdet_sharded(A, nb):
    val, info = par.logdet_sharded("L", _t(A), nb=nb)
    return {"val": val, "info": info}


def solve(A, B, nb, trans):
    """op(L)·X = B through the distributed factor of A."""
    fbc, info = par.potrf_dist(par.distribute(_t(A), nb=nb))
    X, counts = _counted(par.trsm_factor_dist, fbc, _t(B), trans)
    return {"X": X, "info": info, "counts": counts}


def trtri_dist(L, nb, tiles="auto"):
    (W, info), counts = _counted(par.trtri_dist,
                                 par.distribute(_t(L), nb=nb), tiles=tiles)
    return {"W": par.collect(W), "info": info, "counts": counts}


def lauum_dist(L, nb):
    bc = par.distribute(_t(L), nb=nb, pad_identity=False)
    out, counts = _counted(par.lauum_dist, bc)
    return {"B": par.collect(out), "counts": counts}


def potri_dist(A, nb):
    """potrf_dist, then potri_dist on its factor."""
    fbc, info0 = par.potrf_dist(par.distribute(_t(A), nb=nb))
    (out, info), counts = _counted(par.potri_dist, fbc)
    return {"Inv": par.collect(out), "info0": info0, "info": info,
            "counts": counts}


def potri_sharded(F, uplo, nb):
    Inv, info = par.potri_sharded(uplo, _t(F), nb=nb)
    return {"Inv": Inv, "info": info}


def blas(op, args):
    """par.<op>(*args), the numpy arrays among args as tensors."""
    args = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    out, counts = _counted(getattr(par, op), *args)
    return {"out": out, "counts": counts}


def _group_ranks(group):
    return dist.get_process_group_ranks(group) if group is not None else [0]


def gp_step(X, y, probes, params, dp, mp, nb, lr=1e-2):
    """One make_gp_train_step step on this rank's (dp, mp) mesh, fed the
    dp shard of the global batch (X, y, probes) from the parameters
    ``params`` (a numpy triple), with the collectives of the step and
    the rank's place in the mesh."""
    mesh = launch.mesh2d(dp, mp)
    batch, n, d = X.shape
    rows = slice(mesh.i_dp * batch // dp, (mesh.i_dp + 1) * batch // dp)
    dtype = torch.from_numpy(X[:1, :1, :1]).dtype
    step = gp_dist.make_gp_train_step(mesh, n, d, batch, nb=nb,
                                      n_probes=probes.shape[2], lr=lr,
                                      dtype=dtype)
    p0 = gp.params_from_jax(params, device="cpu")
    (new, nll, infos), counts = _counted(
        step, p0, _t(X[rows]), _t(y[rows]), _t(probes[rows]))
    return {"params": torch.stack(list(new)), "nll": nll, "infos": infos,
            "counts": counts, "coords": (mesh.i_dp, mesh.i_mp),
            "mp_ranks": _group_ranks(mesh.mp_group),
            "dp_ranks": _group_ranks(mesh.dp_group)}


def run(rank, cases):
    """Every case of ``cases`` ({name: (function name, kwargs)}) on this
    rank, in order: {name: {output: numpy array or counts}}."""
    out = {}
    for name, (fn, kw) in cases.items():
        res = globals()[fn](**kw)
        out[name] = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                     else v for k, v in res.items()}
    return out



def fail_on(rank, bad):
    """Rank ``bad`` raises; the others wait in a broadcast from it, which
    it never joins (bad = -1: no rank fails, the broadcast is rank 0's)."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    comm.broadcast(torch.zeros(1), max(bad, 0))
    return rank


def stall(rank, seconds):
    """Rank 0 waits in a broadcast from rank 1, which sleeps instead."""
    import time
    if rank == 1:
        time.sleep(seconds)
    else:
        comm.broadcast(torch.zeros(1), 1)
    return rank
