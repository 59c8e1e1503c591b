"""Tuning table: per-device-kind kernel parameters.

The counterpart of ``cholesky_tpu/tuning/table.py`` for the keys the port
reads: ``potrf_f32.{leaf_nb,mega_max_n}`` and
``{trtri,lauum}_f32.mega_max_n``. The JAX package's other keys have no
reader here: ``matmul_f32``, ``syrk_f32`` and ``trmm_f32`` because
``gemm_f32`` and ``syrk_lower_f32`` choose their launch per call
(``launch_plan`` in ops/kernels/gemm.py and syrk.py) and ``trmm_lln_f32``
has one 128 x 128 tile; ``ozaki_f64``, the size from which the JAX
package's d tier peels the factor once for every block product, because
the port's d tier always does: on an H100 that was no slower at any size
(ops/blocked.py ``_OzakiTiles``). Tables are JSON files in ``tables/``
keyed by the slug of ``torch.cuda.get_device_name()``, written on their
card by ``python -m cholesky_tpu_torch.tuning.autotune``; a value a table
does not give, and every value on a card without a table (or on the CPU),
comes from DEFAULTS.
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
    # mega_max_n: largest block factored/inverted/squared by ONE
    # whole-matrix kernel (ops/kernels/mega.py); above it the blocked
    # recursion runs with leaf_nb leaves. The values are the JAX DEFAULTS:
    # the *_stream_f32 kernels reach 8192, as the TPU's *_hbm_f32 do.
    "potrf_f32": {"leaf_nb": 512, "mega_max_n": 8192},
    "trtri_f32": {"mega_max_n": 4096},
    "lauum_f32": {"mega_max_n": 8192},
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
