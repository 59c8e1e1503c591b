"""The device fills (csrc/prng.cu), each beside its plain torch twin:

- uniform_fill_f32 replaces ``cholesky_tpu/rng/pallas_prng.py:
  uniform_device`` (``_fill_kernel``): a rows × cols f32 fill in [0, 1);
- uniform_fill_f64 replaces ``pallas_prng.py:uniform_device64``
  (``_fill_kernel64``): the f64 fill on the 2⁻⁵³ grid, u < 1.

The rows are cut into blocks of ``rows_per_block(rows)`` (256, as the TPU
kernels' grid), each with its own seed; each element's bits are
Philox4x32-10 of its position in its block under that seed. The twins
compute the same words in int64 torch arithmetic, bit for bit: uint32
values carried in int64 and masked, and the high half of a 32 × 32-bit
product taken through 16-bit halves, since a full product would overflow
int64. The TPU's hardware bits cannot be reproduced, so the fills match
the JAX package's contract, not its bits. A CPU seeds tensor takes the
twin; a CUDA one launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check

ROWS_PER_BLOCK = 256        # the TPU kernels' _ROWS_PER_BLOCK
MASK = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def rows_per_block(rows: int) -> int:
    """The row block of a fill of ``rows`` rows: 256, or fewer rows
    rounded up to a multiple of 8 (``pallas_prng.py:68``)."""
    return min(ROWS_PER_BLOCK, -(-rows // 8) * 8)


def mulhilo(a: int, b):
    """(high, low) 32-bit halves of a·b, a a Python int and b an int64
    tensor, both in [0, 2³²), through 16-bit halves so no product leaves
    int64."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    t = ((ah * bl + al * bh) << 16) + al * bl      # < 2⁵⁰
    return ah * bh + (t >> 32), t & MASK


def philox4x32_10(c, k0, k1):
    """Philox4x32-10 of the counter words c = (c0, c1, c2, c3) under the
    key (k0, k1): int64 tensors (or broadcastable ints) holding uint32
    values. Returns the four output words."""
    c0, c1, c2, c3 = c
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK
            k1 = (k1 + PHILOX_W[1]) & MASK
        hi0, lo0 = mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(seeds, rows: int, cols: int, per_call: int):
    """The Philox words of every call of a fill: (nblocks, calls, 4),
    int64, calls the calls per row block."""
    rp = rows_per_block(rows)
    calls = -(-rp * cols // per_call)
    t = torch.arange(calls, dtype=torch.int64, device=seeds.device)[None, :]
    k0 = (seeds.to(torch.int64) & MASK)[:, None]
    zero = torch.zeros_like(t)
    w = philox4x32_10((t & MASK, t >> 32, zero, zero), k0, 0)
    return torch.stack(torch.broadcast_tensors(*w), dim=-1)


def _to_matrix(vals, rows: int, cols: int):
    """(nblocks, calls·E) values → the rows × cols fill: each row block is
    rp·cols consecutive values."""
    rp = rows_per_block(rows)
    return vals[:, :rp * cols].reshape(-1, cols)[:rows]


def uniform_fill_f32_plain(seeds, rows: int, cols: int):
    """The plain torch version, any device: the kernel's f32 fill, bit
    for bit."""
    w = _words(seeds, rows, cols, 4).reshape(seeds.shape[0], -1)
    bits = (0x3F800000 | (w >> 9)).to(torch.int32)
    return _to_matrix(bits.view(torch.float32) - 1.0, rows, cols)


def uniform_fill_f64_plain(seeds, rows: int, cols: int):
    """The plain torch version, any device: the kernel's f64 fill, bit
    for bit."""
    w = _words(seeds, rows, cols, 2)
    hi = w[..., 0::2].reshape(seeds.shape[0], -1)
    lo = w[..., 1::2].reshape(seeds.shape[0], -1)
    u = ((hi << 21) | (lo >> 11)).to(torch.float64) * 2.0 ** -53
    return _to_matrix(u, rows, cols)


def _check_fill(seeds, rows, cols, name):
    check(rows >= 1 and cols >= 1, name, 2,
          f"shape ({rows}, {cols}) must be at least 1 x 1")
    nblocks = -(-rows // rows_per_block(rows))
    check(seeds.dtype == torch.int32 and seeds.shape == (nblocks,), name, 1,
          f"seeds must be int32 of shape ({nblocks},), one per row block, "
          f"got {seeds.dtype} {tuple(seeds.shape)}")
    check(seeds.device.type in ("cpu", "cuda"), name, 1,
          f"unsupported device {seeds.device}")


def _fill(kernel, seeds, rows, cols, dtype):
    out = torch.empty((rows, cols), dtype=dtype, device=seeds.device)
    seeds = seeds.contiguous()
    _build.launch(kernel.__name__, seeds.data_ptr(), rows, cols,
                  rows_per_block(rows), out.data_ptr(),
                  *_build.device_args(out))
    kernel.launches += 1
    return out


def _fill_shape(seeds, rows, cols):
    return {"m": rows, "n": cols}


@_build.kernel_span("uniform_fill_f32", _fill_shape)
def uniform_fill_f32(seeds, rows: int, cols: int):
    """A new rows × cols f32 tensor of uniform values in [0, 1) on the
    device of ``seeds``, the int32 seeds of its row blocks (one per
    ``rows_per_block(rows)`` rows)."""
    _check_fill(seeds, rows, cols, "uniform_fill_f32")
    if seeds.device.type == "cpu":
        return uniform_fill_f32_plain(seeds, rows, cols)
    return _fill(uniform_fill_f32, seeds, rows, cols, torch.float32)


@_build.kernel_span("uniform_fill_f64", _fill_shape)
def uniform_fill_f64(seeds, rows: int, cols: int):
    """A new rows × cols f64 tensor of uniform values in [0, 1) on the
    2⁻⁵³ grid, on the device of ``seeds`` (as :func:`uniform_fill_f32`)."""
    _check_fill(seeds, rows, cols, "uniform_fill_f64")
    if seeds.device.type == "cpu":
        return uniform_fill_f64_plain(seeds, rows, cols)
    return _fill(uniform_fill_f64, seeds, rows, cols, torch.float64)


uniform_fill_f32.launches = 0
uniform_fill_f64.launches = 0
