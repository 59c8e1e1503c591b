"""The collectives of the block-cyclic tier, each counted.

The JAX package runs the tier as one SPMD program over a mesh axis; the
port runs one process per rank of a ``torch.distributed`` group, each
the same eager loop on its own shard. The JAX collectives map onto three:

  psum of a value masked to its owner   ->  :func:`broadcast` from the owner
  psum of true sums                     ->  :func:`all_reduce`
  lax.all_gather                        ->  :func:`all_gather`

``group=None`` is the default group when one is initialised, and
otherwise a world of one (rank 0 of 1, the analogue of a one-device
mesh): every collective then returns its input and needs no
``init_process_group``. Each call adds one to its kind in :data:`COUNTS`
whether or not a group exists, so the counts are the census of the
algorithm's collectives (the port's form of
``tests/test_parallel_hlo.py``).

A CUDA tensor must travel on an NCCL group and a CPU tensor on a gloo
one: nothing is staged through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cholesky_tpu_torch.utils.errors import check

#: kind -> calls since the last :func:`reset_counts`
COUNTS = {"broadcast": 0, "all_reduce": 0, "all_gather": 0}


def counts() -> dict:
    return dict(COUNTS)


def reset_counts() -> None:
    for kind in COUNTS:
        COUNTS[kind] = 0


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    return dist.get_rank(group) if _live() else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if _live() else 1


def _check_backend(t, group, what):
    backend = str(dist.get_backend(group))
    if ":" in backend:      # one backend a device type: "cuda:nccl,cpu:gloo"
        backend = dict(kv.split(":") for kv in backend.split(",")).get(
            t.device.type, "none")
    want = "nccl" if t.device.type == "cuda" else "gloo"
    check(backend == want, what, 1,
          f"a {t.device.type} tensor needs a {want} group, this one is "
          f"{backend}")


def broadcast(t, owner: int, group=None):
    """``t`` from group rank ``owner`` on every rank, in place."""
    COUNTS["broadcast"] += 1
    if _live():
        _check_backend(t, group, "broadcast")
        src = owner if group is None else dist.get_global_rank(group, owner)
        dist.broadcast(t, src=src, group=group)
    return t


def all_reduce(t, group=None):
    """The sum of ``t`` over the ranks, in place."""
    COUNTS["all_reduce"] += 1
    if _live():
        _check_backend(t, group, "all_reduce")
        dist.all_reduce(t, group=group)
    return t


def all_gather(t, group=None) -> list:
    """Every rank's ``t``, in group rank order (the list form, which every
    torch release the port runs on has)."""
    COUNTS["all_gather"] += 1
    if not _live():
        return [t]
    _check_backend(t, group, "all_gather")
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts
