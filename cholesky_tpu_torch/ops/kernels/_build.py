"""Build and load the hand-written CUDA kernels.

Each of ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
at once, and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes``. The library goes into ``build/`` beside
this file (listed in ``.gitignore``), named by a hash of the sources and
the flags, so an edit rebuilds and an unchanged tree
reuses the last build. The build runs on the first kernel launch, never at
import. A failed build raises with nvcc's output; nothing falls back.
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

from cholesky_tpu_torch.utils import profiling
from cholesky_tpu_torch.utils.errors import report_error

_HERE = Path(__file__).parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]


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


def build() -> Build:
    """Compile the kernels if this source tree and these flags have not
    been built yet; returns where the library is."""
    sources = sorted(CSRC.glob("*.cu"))
    flags = NVCC_FLAGS
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
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one compiler per source, all started together, then one link
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{stem}.{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    steps = [(cmd, proc.communicate()[0], proc.returncode)
             for cmd, _, proc in jobs]
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    log.write_text("".join(f"$ {' '.join(cmd)}\n{out}"
                           for cmd, out, _ in steps))
    for cmd, out, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with exit code {rc}:\n"
                               f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, so)             # atomic: a concurrent build is harmless
    return Build(so, seconds, log)


_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        P, LL, I, F, D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float, ctypes.c_double)
        # every entry point ends with (device index, stream)
        signatures = {
            "ct_gemm_f32": [P, LL, LL, P, LL, LL, P, LL, LL, P, LL, LL,
                            I, I, I, F, F, I, I, I, I, I, P],
            "ct_syrk_lower_f32": [P, LL, LL, P, LL, LL, I, I, F, F, I, I, I, I,
                                  P, I, P],
            "ct_potrf_block_f32": [P, LL, I, P, I, I, P],
            "ct_potrf_stream_f32": [P, LL, P, P, P, I, P, P, I, P],
            "ct_trtri_block_f32": [P, LL, P, LL, P, I, P, I, P],
            "ct_trtri_stream_f32": [P, LL, P, LL, P, I, I, I, P, P, I, P],
            "ct_lauum_stream_f32": [P, LL, P, LL, I, LL, I, P, P, I, P],
            "ct_lauu2_f32": [P, LL, P, LL, I, LL, I, P, I, P],
            "ct_potf2_f32": [P, LL, P, P, I, I, I, P, I, P],
            "ct_trti2_f32": [P, LL, P, LL, I, I, I, P, I, P],
            "ct_trmm_lln_f32": [P, LL, LL, P, LL, LL, P, LL, I, I, F, I, I,
                                P],
            "ct_peel_f32pair": [P, LL, LL, P, LL, LL, P, LL, LL, I, I, I, I,
                                I, I, P],
            "ct_mm_groups_f32pair": [P, LL, LL, P, LL, LL, P, P, LL, I, I, I,
                                     I, I, P],
            "ct_peel_f64": [P, LL, LL, P, LL, LL, P, I, I, I, I, I, P],
            "ct_mm_groups_f64": [P, LL, LL, P, LL, LL, P, P, P, LL, LL, D, D,
                                 I, I, I, I, I, P],
            "ct_uniform_fill_f32": [P, LL, LL, I, P, I, P],
            "ct_uniform_fill_f64": [P, LL, LL, I, P, I, P],
            "ct_rbf_f32": [P, LL, P, LL, I, P, P, P, F, I, P, LL, I, P],
            "ct_rbf_grad_f32": [P, LL, P, P, LL, I, P, P, P, I, P, P, I, P],
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


def launch(kernel: str, *args) -> None:
    """Call the entry point ``ct_<kernel>`` with ``args`` and raise if the
    launch failed (:func:`check_launch`). Under
    ``profiling.collect(device=True)`` the kernel span's CUDA events
    bracket this call alone."""
    fn = getattr(library(), f"ct_{kernel}")
    with profiling.launch_events():
        err = fn(*args)
    check_launch(err, kernel)


def dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def square(A, *args, **kwargs) -> dict:
    """The attributes of a launch whose first operand is n × n."""
    return {"n": A.shape[0], "dtype": dtype_name(A)}


def kernel_span(kernel: str, attrs=square):
    """The decorator of a kernel's wrapper: each call is the span
    ``kernel.<kernel>``, its attributes the launch's shape from
    ``attrs(*args, **kwargs)``, its device events around :func:`launch`."""
    return profiling.annotate_function(name=f"kernel.{kernel}", attrs=attrs,
                                       launch=True)


def writable_2d(t) -> bool:
    """Is the 2-D view ``t`` row- or column-major with no two elements at
    one address, so that a kernel may write every element?"""
    m, n = t.shape
    return ((t.stride(1) == 1 and t.stride(0) >= max(n, 1))
            or (t.stride(0) == 1 and t.stride(1) >= max(m, 1)))


def device_args(t) -> tuple[int, int]:
    """(device index, current stream) of CUDA tensor ``t``: the last two
    arguments of every C entry point. The stream's handle comes straight
    from torch's C layer, as its compiled kernels fetch it: a
    torch.cuda.Stream object costs microseconds of host time a launch."""
    index = t.get_device()
    return index, torch._C._cuda_getCurrentRawStream(index)
