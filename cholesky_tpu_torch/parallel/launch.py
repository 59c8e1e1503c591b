"""Starting a world for the block-cyclic tier: what a device mesh gives
the JAX package for free.

- :func:`spawn` runs ``fn(rank, *args)`` on every rank of a new world of
  spawned processes over a ``FileStore`` in a temporary directory and
  returns every rank's result; it raises when a rank fails, exits
  without a result or overruns the timeout, and stops every process it
  started. Each rank runs on one thread (``torch.set_num_threads(1)``),
  so that several worlds can share a machine's cores.
- :func:`init_single` makes the one-rank group of this process on a
  device: NCCL on a card, gloo on the CPU.
- :func:`mesh2d` splits the world into the row and column subgroups of
  a (dp, mp) process mesh, the JAX package's 2-D ``Mesh``.

With ``torchrun`` (``torchrun --nproc-per-node=P script.py``) the script
calls ``torch.distributed.init_process_group`` itself and passes no group
to the tier, which then runs on the default group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world_size, store_path, backend, timeout, fn, args,
               results):
    torch.set_num_threads(1)
    if backend == "nccl":       # one rank a card
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    try:
        results.put((rank, fn(rank, *args)))
    finally:
        dist.destroy_process_group()


def _drain(results, got: dict) -> None:
    try:
        while True:
            rank, out = results.get(timeout=0.1)
            got[rank] = out
    except queue.Empty:
        pass


def _tracebacks(ctx) -> str:
    """Every failed rank's traceback: ProcessContext.join reports one
    rank only, often a peer cut off by the first failure."""
    out = []
    for rank, path in enumerate(ctx.error_files):
        if os.path.exists(path):
            with open(path, "rb") as fh:
                out.append(f"rank {rank} failed:\n{pickle.load(fh)}")
            os.unlink(path)
    return "\n".join(out)


def spawn(world_size: int, fn, *args, backend: str = "gloo",
          timeout: float = 300.0) -> list:
    """[fn(0, *args), ..., fn(world_size - 1, *args)], each run in its own
    spawned process of one world. ``fn`` and its arguments and result are
    pickled: ``fn`` must be importable by name from a module that the
    children can import cheaply (no JAX), and the results should be plain
    data (numpy arrays, numbers). Under ``backend="nccl"`` rank r runs on
    card r."""
    results = mp.get_context("spawn").Queue()
    deadline = time.monotonic() + timeout
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(world_size, os.path.join(tmp, "store"), backend, timeout,
                  fn, args, results))
        try:
            # a rank's result must be read before the rank can exit
            while not ctx.join(timeout=0.5):
                _drain(results, got)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn: {world_size - len(got)} of {world_size} "
                        f"ranks gave no result within {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError("spawn: " + (_tracebacks(ctx) or str(e))) from e
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        _drain(results, got)
    results.close()
    if len(got) < world_size:
        raise RuntimeError(f"spawn: {world_size - len(got)} of {world_size} "
                           "ranks exited without a result")
    return [got[rank] for rank in range(world_size)]


def init_single(device) -> None:
    """Initialise this process's default group as a world of one on
    ``device``: NCCL for a CUDA device (which becomes the current one),
    gloo for the CPU. Call ``torch.distributed.destroy_process_group()``
    when done."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if device.index is None else device.index)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's place in a (dp, mp) process mesh: rank = i_dp·mp + i_mp,
    the layout of the JAX package's ``Mesh(devs.reshape(dp, mp), ("dp",
    "mp"))``. ``mp_group`` holds the mp ranks of this rank's dp index (its
    row: one problem's matrix is spread over it), ``dp_group`` the dp
    ranks of its mp index (its column: the batch is reduced over it);
    both are None in a world of one with no process group."""
    dp: int
    mp: int
    i_dp: int
    i_mp: int
    dp_group: object = None
    mp_group: object = None


def mesh2d(dp: int, mp: int) -> Mesh2D:
    """This rank's :class:`Mesh2D` over the default group, whose size must
    be dp·mp. Every rank creates every row group, then every column group,
    in the same order (``dist.new_group`` is collective over the world,
    including the ranks a group leaves out)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not (dp >= 1 and mp >= 1 and dp * mp == world):
        raise ValueError(f"mesh2d: dp·mp = {dp}·{mp} does not match the "
                         f"world of {world}")
    if not dist.is_initialized():
        return Mesh2D(1, 1, 0, 0)
    i_dp, i_mp = divmod(dist.get_rank(), mp)
    rows = [dist.new_group([i * mp + j for j in range(mp)])
            for i in range(dp)]
    cols = [dist.new_group([i * mp + j for i in range(dp)])
            for j in range(mp)]
    return Mesh2D(dp, mp, i_dp, i_mp, dp_group=cols[i_mp],
                  mp_group=rows[i_dp])
