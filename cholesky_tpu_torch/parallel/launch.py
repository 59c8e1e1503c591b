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

With ``torchrun`` (``torchrun --nproc-per-node=P script.py``) the script
calls ``torch.distributed.init_process_group`` itself and passes no group
to the tier, which then runs on the default group.
"""

from __future__ import annotations

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
    data (numpy arrays, numbers)."""
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
