"""The benchmark's plain references: straightforward PyTorch versions of
what each cell's timed path computes, written out again from the
mathematics. They import neither JAX nor ``cholesky_tpu`` nor anything of
``cholesky_tpu_torch``, and take nothing the program made: the harness
hands them the same inputs it handed the program.

Every routine takes a precision, ``"f64"`` (the reference) or ``"tf32"``
(the control: float32 storage with every matrix product's operands
rounded to TF32, the step below the float32-without-TF32 that the
configurations state).
"""

import torch

# a float32 product must be float32: the control rounds its operands to
# TF32 itself, and nothing else may
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRECISIONS = {"f64": torch.float64, "tf32": torch.float32}


def tf32(x):
    """``x`` (float32) rounded to TF32: 10 explicit mantissa bits, to
    nearest, ties away from zero, as the tensor cores read their
    operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a, b, prec):
    """a @ b in ``prec``: plain float64, or float32 accumulation of
    TF32-rounded operands (exact products, as on the tensor cores)."""
    if prec == "tf32":
        return torch.matmul(tf32(a), tf32(b))
    return torch.matmul(a, b)
