"""The two kernels of the d tier's Ozaki products (ops/ozaki.py), each
beside its plain torch twin:

- peel_f32pair (csrc/ozaki_peel.cu) replaces ``cholesky_tpu/ops/pallas/
  ozaki_split.py:peel_f32pair``: the S int8 slices of an exact f32 pair,
  bit for bit;
- mm_groups_f32pair (csrc/ozaki_mm.cu) replaces ``cholesky_tpu/ops/pallas/
  ozaki_mm.py:mm_groups_f32pair``: all slice products, summed by weight
  group, as an f32 (hi, lo) pair.

A CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check

SLICE_BITS = 7      # bits per slice, as the JAX package's ozaki_mm.SLICE_BITS
MAX_SLICES = 8      # the kernels' limit, and the S of ozaki.K_EXACT_MAX
ALIGN = 16          # bytes: where the kernel's slice rows start on the card


def peel_plain(rh, rl, slices: int):
    """The plain torch version, any device: the JAX package's
    round-and-subtract loop, one torch pass per operation, so nothing is
    contracted into an FMA. Returns a contiguous (S, m, k) int8 tensor."""
    outs = []
    for _ in range(slices):
        hb = rh * 128.0
        q = torch.round(hb)                 # half to even, as jnp.round
        outs.append(q.to(torch.int8))
        d = hb - q                          # |d| <= 1/2: exact
        lb = rl * 128.0
        t = d + lb                          # two-sum: new hi ...
        rl = lb - (t - d)                   # ... and its exact error
        rh = t
    return torch.stack(outs)


def _peel_shape(rh, rl, *, slices):
    return {"m": rh.shape[0], "k": rh.shape[1], "slices": slices}


@_build.kernel_span("peel_f32pair", _peel_shape)
def peel_f32pair(rh, rl, *, slices: int):
    """int8 slices (S, m, k) of the exact pair value rh + rl, f32 (m, k)
    strided views already scaled into [-1/2, 1/2]. On the card the result
    is a view of an (S, m, kp) buffer whose rows are padded to a multiple
    of ALIGN bytes, so that its rows, and the rows of any sub-block at a k
    offset that is a multiple of ALIGN, reach :func:`mm_groups_f32pair`'s
    kernel without a copy."""
    check(rh.ndim == 2 and rh.shape == rl.shape, "peel_f32pair", 1,
          f"rh and rl must be 2-D of one shape, got {tuple(rh.shape)} and "
          f"{tuple(rl.shape)}")
    check(rh.dtype == rl.dtype == torch.float32, "peel_f32pair", 1,
          "float32 operands only")
    check(rh.device == rl.device, "peel_f32pair", 2,
          "operands on different devices")
    check(1 <= slices <= MAX_SLICES, "peel_f32pair", 3,
          f"slices={slices} outside 1..{MAX_SLICES}")
    if rh.device.type == "cpu":
        return peel_plain(rh, rl, slices)
    check(rh.device.type == "cuda", "peel_f32pair", 1,
          f"unsupported device {rh.device}")
    m, k = rh.shape
    kp = -(-max(k, 1) // ALIGN) * ALIGN
    out = torch.empty((slices, m, kp), dtype=torch.int8, device=rh.device)
    if m == 0 or k == 0:
        return out[:, :, :k]
    vec_in = all(t.stride(1) == 1 and t.stride(0) % 4 == 0
                 and t.data_ptr() % 16 == 0 for t in (rh, rl))
    _build.launch(
        "peel_f32pair", rh.data_ptr(), rh.stride(0), rh.stride(1),
        rl.data_ptr(), rl.stride(0), rl.stride(1),
        out.data_ptr(), kp, m * kp, m, k, kp, slices, int(vec_in),
        *_build.device_args(rh))
    peel_f32pair.launches += 1
    return out[:, :, :k]


def _check_groups(As, Bs):
    check(As.ndim == 3 and Bs.ndim == 3, "mm_groups_f32pair", 1,
          "As and Bs must be (S, rows, k)")
    S, m, k = As.shape
    check(Bs.shape[0] == S and Bs.shape[2] == k, "mm_groups_f32pair", 2,
          f"slices/k mismatch: {tuple(As.shape)} and {tuple(Bs.shape)}")
    check(As.dtype == Bs.dtype == torch.int8, "mm_groups_f32pair", 1,
          "int8 slices only")
    check(As.device == Bs.device, "mm_groups_f32pair", 2,
          "operands on different devices")
    check(1 <= S <= MAX_SLICES, "mm_groups_f32pair", 1,
          f"S={S} outside 1..{MAX_SLICES}")
    return S, m, Bs.shape[1], k


def mm_groups_plain(As, Bs):
    """The plain torch version, any device: each group sum G_g as exact f64
    products of the int8 values (exact below 2^53), x = sum_g 2^(-7(g+2))
    G_g in f64, returned as hi = f32(x), lo = f32(x - hi)."""
    S, m, n, _ = _check_groups(As, Bs)
    A64, B64 = As.double(), Bs.double()
    x = torch.zeros((m, n), dtype=torch.float64, device=As.device)
    for g in range(S):
        G = sum(A64[s] @ B64[g - s].T for s in range(g + 1))
        x += G * 2.0 ** (-SLICE_BITS * (g + 2))
    hi = x.float()
    return hi, (x - hi.double()).float()


def aligned_rows(X):
    """X itself when its k axis is unit-stride and every slice row starts
    on an ALIGN-byte boundary (the kernel's 16-byte copies need both), else
    X copied by one ``copy_`` into a new (S, rows, kp) buffer, kp the k
    extent rounded up to ALIGN, and viewed back to (S, rows, k): a
    sub-block of a peel at any k offset, a transposed view. The kernel
    zero-fills past k itself and never reads the pad."""
    S, rows, k = X.shape
    if ((X.stride(2) == 1 or k <= 1) and X.data_ptr() % ALIGN == 0
            and X.stride(0) % ALIGN == 0 and X.stride(1) % ALIGN == 0):
        return X
    kp = -(-max(k, 1) // ALIGN) * ALIGN
    buf = X.new_empty((S, rows, kp))
    buf[:, :, :k].copy_(X)
    return buf[:, :, :k]


def _groups_shape(As, Bs):
    return {"slices": As.shape[0], "m": As.shape[1], "n": Bs.shape[1],
            "k": As.shape[2]}


@_build.kernel_span("mm_groups_f32pair", _groups_shape)
def mm_groups_f32pair(As, Bs):
    """Group-weighted slice-product sum of As (S, m, k) and Bs (S, n, k),
    int8, as an f32 pair (hi, lo), (m, n) each:
    hi + lo = sum_g 2^(-7(g+2)) sum_{s+t=g} As[s]·Bs[t]ᵀ, g < S. Both may
    be any strided views; on the card one whose rows do not start on
    ALIGN-byte boundaries with a unit k stride (a sub-block of a peel at a
    k offset that is not a multiple of ALIGN) is first copied into an
    aligned buffer (:func:`aligned_rows`)."""
    S, m, n, k = _check_groups(As, Bs)
    if As.device.type == "cpu":
        return mm_groups_plain(As, Bs)
    check(As.device.type == "cuda", "mm_groups_f32pair", 1,
          f"unsupported device {As.device}")
    As, Bs = aligned_rows(As), aligned_rows(Bs)
    hi = torch.empty((m, n), dtype=torch.float32, device=As.device)
    lo = torch.empty_like(hi)
    if m == 0 or n == 0:
        return hi, lo
    _build.launch(
        "mm_groups_f32pair", As.data_ptr(), As.stride(0), As.stride(1),
        Bs.data_ptr(), Bs.stride(0), Bs.stride(1),
        hi.data_ptr(), lo.data_ptr(), n, S, m, n, k,
        *_build.device_args(As))
    mm_groups_f32pair.launches += 1
    return hi, lo


peel_f32pair.launches = 0
mm_groups_f32pair.launches = 0
