"""BLAS/LAPACK flag enums and the precision registry.

The same str-valued enums as ``cholesky_tpu.types`` (the reference's
Fortran characters 'N'/'T'/'C', 'U'/'L', 'L'/'R', 'U'/'N'), over torch
dtypes. The semantics are copied, not imported: the JAX package's module
imports ``jax.numpy``.
"""

from __future__ import annotations

import enum

import torch


class Side(str, enum.Enum):
    LEFT = "L"
    RIGHT = "R"


class Uplo(str, enum.Enum):
    UPPER = "U"
    LOWER = "L"


class Trans(str, enum.Enum):
    NO_TRANS = "N"
    TRANS = "T"
    CONJ_TRANS = "C"


class Diag(str, enum.Enum):
    NON_UNIT = "N"
    UNIT = "U"


def _norm(value, enum_cls, name: str):
    """Normalize a char or enum into the enum; raise on anything else."""
    if isinstance(value, enum_cls):
        return value
    if isinstance(value, str):
        v = value.upper()
        for member in enum_cls:
            if member.value == v:
                return member
    raise ValueError(f"invalid {name}: {value!r} (expected one of "
                     f"{[m.value for m in enum_cls]})")


def norm_side(side) -> Side:
    return _norm(side, Side, "side")


def norm_uplo(uplo) -> Uplo:
    return _norm(uplo, Uplo, "uplo")


def norm_trans(trans) -> Trans:
    return _norm(trans, Trans, "trans")


def norm_diag(diag) -> Diag:
    return _norm(diag, Diag, "diag")


#: LAPACK precision letter -> torch dtype
PRECISIONS = {
    "s": torch.float32,
    "d": torch.float64,
    "c": torch.complex64,
    "z": torch.complex128,
}

#: complex dtype -> underlying real dtype
REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
    torch.float32: torch.float32,
    torch.float64: torch.float64,
}


def is_complex(dtype) -> bool:
    return dtype.is_complex


def real_dtype(dtype):
    return REAL_OF[dtype]


def precision_letter(dtype) -> str:
    for letter, dt in PRECISIONS.items():
        if dt == dtype:
            return letter
    raise ValueError(f"unsupported precision: {dtype}")
