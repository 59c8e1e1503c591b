"""Bulk uniform fills on the card: ``uniform_device`` (f32) and
``uniform_device64`` (f64).

The counterpart of ``cholesky_tpu/rng/pallas_prng.py``, the rebuild of
the reference's MTGP32/64 generators (reference rng/mtgp32.cu): filling a
large device buffer with uniform floats without a trip to the host. The
rows are cut into blocks of 256, each seeded by ``_mix_seeds`` (a copy,
bit for bit, of the JAX package's hash), and filled by the hand-written
CUDA kernels of ops/kernels/prng.py (Philox4x32-10). The four intervals
of the reference's rng.h are the transforms of rng/generators.py, applied
after the kernel as the JAX package applies them.

The card is the default device; ``device="cpu"`` runs the kernels' plain
twins, which give the same values bit for bit.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels.prng import (MASK, rows_per_block,
                                                 uniform_fill_f32,
                                                 uniform_fill_f64)
from cholesky_tpu_torch.rng.generators import Interval, interval_transform

#: the salt that separates the f64 fills' seeds from the f32 fills'
SALT_F64 = 0x64646464


def _mullo(z, c: int):
    """(z·c) mod 2³² for an int64 tensor z in [0, 2³²), through 16-bit
    halves, so no product leaves int64."""
    return ((((z >> 16) * (c & 0xFFFF) + (z & 0xFFFF) * (c >> 16)) << 16)
            + (z & 0xFFFF) * (c & 0xFFFF)) & MASK


def _mix_seeds(seed: int, n: int, salt: int = 0):
    """n decorrelated per-block seeds from (seed, block index, salt), the
    JAX package's splitmix32-style finalizer (``pallas_prng.py:33-44``)
    bit for bit: uint32 arithmetic carried in int64 and masked. Returns
    int32 with the same bits as JAX's. Adjacent seeds share no row block:
    the former additive scheme made block i of seed s block i − 1 of
    seed s + 1."""
    i = torch.arange(1, n + 1, dtype=torch.int64)
    z = (((seed & MASK) ^ salt) + _mullo(i, 0x9E3779B9)) & MASK
    z = _mullo(z ^ (z >> 16), 0x7FEB352D)
    z = _mullo(z ^ (z >> 15), 0x846CA68B)
    z = z ^ (z >> 16)
    return torch.where(z >= 2 ** 31, z - 2 ** 32, z).to(torch.int32)


def _seeds(seed: int, rows: int, salt: int, device):
    return _mix_seeds(seed, -(-rows // rows_per_block(rows)), salt).to(device)


def uniform_device(seed: int, shape, interval=Interval.HALF_OPEN_01,
                   device="cuda"):
    """A uniform f32 fill of the 2-D ``shape`` on ``device`` (the card by
    default), deterministic in (seed, shape), with the interval semantics
    of the reference's rng.h variants."""
    rows, cols = shape
    u = uniform_fill_f32(_seeds(seed, rows, 0, device), rows, cols)
    return interval_transform(u, interval)


def uniform_device64(seed: int, shape, interval=Interval.HALF_OPEN_01,
                     device="cuda"):
    """A uniform f64 fill of the 2-D ``shape`` with full 53-bit resolution
    (the reference's rng64/MTGP64 tier, rng.h:131-235): every value of the
    [0, 1) fill is a multiple of 2⁻⁵³ below 1. Deterministic in
    (seed, shape); the interval semantics of :func:`uniform_device`."""
    rows, cols = shape
    u = uniform_fill_f64(_seeds(seed, rows, SALT_F64, device), rows, cols)
    return interval_transform(u, interval)
