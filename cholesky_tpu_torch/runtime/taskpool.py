"""ctypes binding for the native C++ task runtime (runtime/csrc/taskpool.cpp):
the counterpart of ``cholesky_tpu/runtime/taskpool.py``.

API surface mirrors the reference's include/cumultigpu.h:11-96:
  Task      ← CUtask   (create / execute / destroy-as-join)
  TaskPool  ← CUmultiGPU (create(n, sequential) / run / synchronize /
                          count / destroy)

The shared library is built from the repo's source on first use with g++
into ``build/`` beside this file (listed in ``.gitignore``), named by a
hash of the source as ``ops/kernels/_build.py`` names the kernels. Each
build writes a name of its own and moves it into place with
``os.replace``, so processes that build at once (test workers) each load
a whole library. A failed build raises with g++'s output; nothing falls
back to a Python pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

_SRC = Path(__file__).parent / "csrc" / "taskpool.cpp"
BUILD_DIR = Path(__file__).parent / "build"
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-pthread"]
_build_lock = threading.Lock()
_lib = None

_ERROR_NAMES = {
    0: "CTP_OK",
    1: "CTP_ERROR_INVALID_VALUE",
    2: "CTP_ERROR_OUT_OF_MEMORY",
    3: "CTP_ERROR_OPERATING_SYSTEM",
    4: "CTP_ERROR_WORKER_FAILED",
}

_TASK_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)


class TaskPoolError(RuntimeError):
    def __init__(self, code: int, what: str):
        super().__init__(f"{what}: {_ERROR_NAMES.get(code, code)}")
        self.code = code


def build() -> Path:
    """The library built from this source tree and these flags, compiled
    if ``BUILD_DIR`` does not hold it yet."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libtaskpool_{h.hexdigest()[:16]}.so"
    with _build_lock:
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                           ".tmp")
        cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}"
                               f":\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)         # atomic: a concurrent build is harmless
        return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.ctp_task_create.argtypes = [ctypes.POINTER(ctypes.c_void_p), _TASK_FN,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.ctp_task_execute.argtypes = [ctypes.c_void_p]
    lib.ctp_task_destroy.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.ctp_pool_create.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.c_int, ctypes.c_int]
    lib.ctp_pool_run.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.ctp_pool_count.argtypes = [ctypes.c_void_p]
    lib.ctp_pool_synchronize.argtypes = [ctypes.c_void_p]
    lib.ctp_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.ctp_error_string.argtypes = [ctypes.c_int]
    lib.ctp_error_string.restype = ctypes.c_char_p
    for f in ["ctp_task_create", "ctp_task_execute", "ctp_task_destroy",
              "ctp_pool_create", "ctp_pool_run", "ctp_pool_count",
              "ctp_pool_synchronize", "ctp_pool_destroy"]:
        getattr(lib, f).restype = ctypes.c_int
    _lib = lib
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        raise TaskPoolError(code, what)


class Task:
    """A heap task closure; ``join()`` (≡ the reference's cuTaskDestroy)
    blocks until the task ran somewhere and returns its int result."""

    def __init__(self, fn: Callable[[], int]):
        lib = _load()
        self._result: Optional[int] = None

        # Trampoline: the Python callable is captured here; the C side
        # calls the CFUNCTYPE pointer. Keep a reference so it outlives the
        # task.
        def _tramp(_arg):
            try:
                r = fn()
                return 0 if r is None else int(r)
            except Exception:
                return 4  # CTP_ERROR_WORKER_FAILED
        self._ctramp = _TASK_FN(_tramp)
        handle = ctypes.c_void_p()
        _check(lib.ctp_task_create(ctypes.byref(handle), self._ctramp,
                                   None, 0), "ctp_task_create")
        self._handle = handle

    def execute(self) -> None:
        _check(_load().ctp_task_execute(self._handle), "ctp_task_execute")

    def join(self) -> int:
        if self._result is None:
            res = ctypes.c_int(0)
            _check(_load().ctp_task_destroy(self._handle, ctypes.byref(res)),
                   "ctp_task_destroy")
            self._handle = None
            self._result = res.value
        return self._result


class TaskPool:
    """Pool of native worker threads, one FIFO queue each; or the
    deterministic sequential variant (``sequential=True``) that executes
    inline — the reference's libcumultigpu_seq.a fake backend."""

    def __init__(self, n_workers: int, sequential: bool = False):
        lib = _load()
        handle = ctypes.c_void_p()
        _check(lib.ctp_pool_create(ctypes.byref(handle), n_workers,
                                   1 if sequential else 0), "ctp_pool_create")
        self._handle = handle
        self.sequential = sequential
        self._live_tasks: list[Task] = []

    @property
    def n_workers(self) -> int:
        return _load().ctp_pool_count(self._handle)

    def run(self, worker: int, fn: Callable[[], int]) -> Task:
        t = Task(fn)
        _check(_load().ctp_pool_run(self._handle, worker, t._handle),
               "ctp_pool_run")
        self._live_tasks.append(t)
        return t

    def map(self, fns) -> list[int]:
        """Round-robin the callables over workers (the reference's
        ``ctx++ % nCtxs`` tile scheduling, sgemm.c:503-505); join all."""
        tasks = [self.run(i % self.n_workers, fn) for i, fn in enumerate(fns)]
        return [t.join() for t in tasks]

    def synchronize(self) -> None:
        _check(_load().ctp_pool_synchronize(self._handle),
               "ctp_pool_synchronize")

    def close(self) -> None:
        if self._handle is not None:
            # outstanding tasks must be joined before the queues shut down
            for t in self._live_tasks:
                if t._handle is not None:
                    t.join()
            self._live_tasks.clear()
            _check(_load().ctp_pool_destroy(self._handle), "ctp_pool_destroy")
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
