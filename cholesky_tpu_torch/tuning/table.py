"""Tuning table: per-device-kind kernel parameters.

The counterpart of ``cholesky_tpu/tuning/table.py``, with the same key set
(``matmul_f32``, ``syrk_f32``, ``potrf_f32.{leaf_nb,mega_max_n}``,
``trtri_f32.mega_max_n``). Tables are JSON files in ``tables/`` keyed by
the slug of ``torch.cuda.get_device_name()``; none is shipped until a value
has been measured on its card, so DEFAULTS apply everywhere.
"""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path

import torch

_TABLES_DIR = Path(__file__).parent / "tables"

#: shipped defaults, used when no table matches the device
DEFAULTS = {
    # output tile (bm x bn) and k-step (bk) of the shared-memory SGEMM
    # (ops/kernels/csrc/gemm.cu); passed to nvcc, so a change rebuilds
    "matmul_f32": {"bm": 64, "bn": 64, "bk": 16},
    # the lower-triangle SYRK reuses the SGEMM tile: bn x bn, k-step bk
    "syrk_f32": {"bn": 64, "bk": 16},
    # mega_max_n: largest block factored/inverted by ONE whole-block
    # kernel (ops/kernels/mega.py); above it the blocked recursion runs
    # with leaf_nb leaves. 1024 is the whole-block kernels' hard cap: the
    # port has no counterpart of the TPU's HBM-streaming kernels yet.
    "potrf_f32": {"leaf_nb": 512, "mega_max_n": 1024},
    "trtri_f32": {"mega_max_n": 1024},
}


def _slug(device_kind: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", device_kind.lower()).strip("_")


def _resolve_device_kind() -> str | None:
    """The name of CUDA device 0 when there is one, else None (DEFAULTS
    apply)."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return None


def table_path(device_kind: str) -> Path:
    return _TABLES_DIR / f"{_slug(device_kind)}.json"


@functools.lru_cache(maxsize=8)
def load_table(device_kind: str | None) -> dict:
    if device_kind is None:
        return {}
    p = table_path(device_kind)
    if not p.exists():
        return {}
    with open(p) as f:
        return json.load(f)


def get_params(op: str, device_kind: str | None = None) -> dict:
    """Tuned parameters for ``op`` on the current device, falling back to
    the shipped defaults."""
    if device_kind is None:
        device_kind = _resolve_device_kind()
    base = dict(DEFAULTS.get(op, {}))
    base.update(load_table(device_kind).get(op, {}))
    return base
