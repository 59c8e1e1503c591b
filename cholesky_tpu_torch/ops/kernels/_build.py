"""Build and load the hand-written CUDA kernels.

All of ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ``ctypes``. The
library goes into ``build/`` beside this file (listed in ``.gitignore``),
named by a hash of the sources and the flags, so an edit or a new tile
shape rebuilds and an unchanged tree reuses the last build. The build runs
on the first kernel launch, never at import. A failed build raises with
nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from cholesky_tpu_torch.tuning import get_params
from cholesky_tpu_torch.utils.errors import report_error

_HERE = Path(__file__).parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path          # the shared library
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    log: Path           # nvcc's output, with ptxas' registers and spills


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA "
                           "kernels are built from source on first use")
    return str(path)


def _tile_flags() -> list[str]:
    mm = get_params("matmul_f32")
    sy = get_params("syrk_f32")
    return [f"-DGEMM_BM={mm['bm']}", f"-DGEMM_BN={mm['bn']}",
            f"-DGEMM_BK={mm['bk']}", f"-DSYRK_BN={sy['bn']}",
            f"-DSYRK_BK={sy['bk']}"]


def build() -> Build:
    """Compile the kernels if this source tree and these flags have not
    been built yet; returns where the library is."""
    sources = sorted(CSRC.glob("*.cu"))
    flags = NVCC_FLAGS + _tile_flags()
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    stem = f"libcholesky_kernels_{h.hexdigest()[:16]}"
    so = BUILD_DIR / f"{stem}.so"
    log = BUILD_DIR / f"{stem}.log"
    if so.exists():
        return Build(so, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log.write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)             # atomic: a concurrent build is harmless
    return Build(so, seconds, log)


_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        P, LL, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        # every entry point ends with (device index, stream)
        signatures = {
            "ct_gemm_f32": [P, LL, LL, P, LL, LL, P, LL, LL, P, LL, LL,
                            I, I, I, F, F, I, P],
            "ct_syrk_lower_f32": [P, LL, LL, P, LL, LL, I, I, F, F, I, P],
            "ct_potrf_block_f32": [P, LL, I, P, I, P],
            "ct_trtri_block_f32": [P, LL, P, LL, I, P, I, P],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ct_error_string.argtypes = [ctypes.c_int]
        lib.ct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(err: int, kernel: str) -> None:
    """Report through the error hook and raise if a launch returned a CUDA
    error: a refused launch never runs, and a later synchronize would not
    report it."""
    if err != 0:
        msg = library().ct_error_string(err).decode()
        report_error(kernel, err, msg, "launch")
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch ({msg})")


def writable_2d(t) -> bool:
    """Is the 2-D view ``t`` row- or column-major with no two elements at
    one address, so that a kernel may write every element?"""
    m, n = t.shape
    return ((t.stride(1) == 1 and t.stride(0) >= max(n, 1))
            or (t.stride(0) == 1 and t.stride(1) >= max(m, 1)))


def device_args(t) -> tuple[int, int]:
    """(device index, current stream) of CUDA tensor ``t``: the last two
    arguments of every C entry point."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream
