"""The port's native task pool (cholesky_tpu_torch/runtime) held to the
contracts of tests/test_taskpool.py, each case run on the port's pool and
on the JAX package's (cholesky_tpu.runtime): the same closures give the
same return codes, TaskPoolError codes and latched error. Beside them:
two processes that build the library at once into one cold directory
both load it, and a failed build raises with g++'s output."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import cholesky_tpu.runtime as jax_runtime
import cholesky_tpu.runtime.taskpool as jax_taskpool
import cholesky_tpu_torch.runtime as torch_runtime
from cholesky_tpu_torch.runtime import taskpool as torch_taskpool
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_pool_lib(tmp_path_factory):
    """The JAX binding builds next to its source; here it builds into a
    directory of this module, so that no other test process's build of
    that file is overwritten while it loads."""
    if jax_taskpool._lib is not None:
        yield
        return
    d = tmp_path_factory.mktemp("jax_taskpool")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_taskpool, "_LIB", d / "libtaskpool.so")
        mp.setattr(jax_taskpool, "_STAMP", d / "libtaskpool.srchash")
        jax_taskpool._load()
        yield


@pytest.fixture(params=["torch", "jax"])
def rt(request, jax_pool_lib):
    return torch_runtime if request.param == "torch" else jax_runtime


def test_task_execute_and_join(rt):
    hits = []
    t = rt.Task(lambda: hits.append(1) or 7)
    t.execute()
    assert t.join() == 7
    assert hits == [1]


def test_task_join_returns_result_once(rt):
    t = rt.Task(lambda: 3)
    t.execute()
    assert t.join() == 3
    assert t.join() == 3  # cached after destroy


def test_pool_runs_on_workers(rt):
    with rt.TaskPool(4) as pool:
        assert pool.n_workers == 4
        ids = []
        lock = threading.Lock()

        def work(i):
            def fn():
                with lock:
                    ids.append((i, threading.get_ident()))
                return 0
            return fn

        results = pool.map([work(i) for i in range(16)])
        assert results == [0] * 16
        assert sorted(i for i, _ in ids) == list(range(16))
        # work landed on native threads, not the caller
        assert all(tid != threading.get_ident() for _, tid in ids)


def test_pool_join_blocks_until_complete(rt):
    with rt.TaskPool(1) as pool:
        done = threading.Event()

        def slow():
            time.sleep(0.2)
            done.set()
            return 0

        t = pool.run(0, slow)
        assert t.join() == 0
        assert done.is_set()


def test_pool_out_of_range_worker(rt):
    with rt.TaskPool(2) as pool:
        with pytest.raises(rt.TaskPoolError):
            pool.run(5, lambda: 0)
        with pytest.raises(rt.TaskPoolError):
            pool.run(-1, lambda: 0)


def test_pool_invalid_create(rt):
    with pytest.raises(rt.TaskPoolError):
        rt.TaskPool(0)


def test_sequential_pool_is_inline_and_deterministic(rt):
    with rt.TaskPool(3, sequential=True) as pool:
        order = []
        tid = threading.get_ident()
        inline = []

        def work(i):
            def fn():
                order.append(i)
                inline.append(threading.get_ident() == tid)
                return 0
            return fn

        pool.map([work(i) for i in range(9)])
        assert order == list(range(9))       # strict submission order
        assert all(inline)                   # ran on the caller's thread


def test_worker_error_latched_and_reported_at_destroy(rt):
    pool = rt.TaskPool(2)
    t = pool.run(0, lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert t.join() == 4  # CTP_ERROR_WORKER_FAILED from the trampoline
    with pytest.raises(rt.TaskPoolError):
        pool.close()


def test_synchronize_barrier(rt):
    with rt.TaskPool(2) as pool:
        state = []
        pool.run(0, lambda: state.append("a") or 0)
        pool.run(1, lambda: state.append("b") or 0)
        pool.synchronize()
        assert sorted(state) == ["a", "b"]


def _behaviour(rt) -> dict:
    """Return codes, error codes and the latched error of one set of
    closures on one package's pool."""
    out = {}

    def boom():
        raise ValueError("boom")

    closures = {"zero": lambda: 0, "seven": lambda: 7, "none": lambda: None,
                "raises": boom}
    for name, fn in closures.items():
        t = rt.Task(fn)
        t.execute()
        out[f"task {name}"] = t.join()
    for name, call in {"pool 0": lambda: rt.TaskPool(0),
                       "pool -3": lambda: rt.TaskPool(-3)}.items():
        with pytest.raises(rt.TaskPoolError) as e:
            call()
        out[name] = e.value.code
    for sequential in (False, True):
        pool = rt.TaskPool(3, sequential=sequential)
        for worker in (3, -1):
            with pytest.raises(rt.TaskPoolError) as e:
                pool.run(worker, lambda: 0)
            out[f"run {worker} {sequential}"] = e.value.code
        out[f"map {sequential}"] = pool.map(list(closures.values()))
        with pytest.raises(rt.TaskPoolError) as e:
            pool.close()
        out[f"close {sequential}"] = (e.value.code, str(e.value))
    return out


def test_same_codes_as_the_jax_pool(jax_pool_lib):
    got = _behaviour(torch_runtime)
    assert got == _behaviour(jax_runtime)
    assert got["task raises"] == 4
    assert got["close False"][0] == 4
    assert torch_taskpool._ERROR_NAMES == jax_taskpool._ERROR_NAMES


_BUILD_AND_RUN = """
import sys
from pathlib import Path
from cholesky_tpu_torch.runtime import taskpool
taskpool.BUILD_DIR = Path(sys.argv[1])
with taskpool.TaskPool(2) as pool:
    print(pool.map([lambda: 0] * 4), taskpool.build().name)
"""


def test_concurrent_builds_into_one_cold_directory(tmp_path):
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_RUN,
                               str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    # 8-13 s in the suite under six workers
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.split()[-1] for out, _ in outs}
    assert all(out.startswith("[0, 0, 0, 0]") for out, _ in outs)
    assert len(names) == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(names)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "taskpool.cpp"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(torch_taskpool, "_SRC", bad)
    monkeypatch.setattr(torch_taskpool, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        torch_taskpool.build()
    assert "error" in str(e.value)
    assert list((tmp_path / "build").iterdir()) == []
