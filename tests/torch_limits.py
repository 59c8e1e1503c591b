"""Limits for the port's CPU tests. Each tests/test_torch_*.py file but the
card's imports the two fixtures below, which pytest then uses for that file
alone:

    from tests.torch_limits import module_time_limit, time_limit  # noqa: F401

Under xdist the workers share the CPUs: each worker's torch intra-op pool
at its default of one thread a CPU oversubscribes them, and its threads
spin while they wait (test_hoisted_recursions_leave_no_cyclic_garbage took
0.7 s on one thread alone, 4 s on eight and 99 s in the suite). Importing
this module caps the pool at the worker's share of the CPUs it may use.

Every test's setup, call and teardown run under a limit far inside the
suite's: an overrun fails the test and names the limit. The module's own
fixtures of wider scope (a spawned ``world``), made in the setup of the
first test that asks for them, run under it too. The alarm's handler runs
only between Python bytecodes, so a call that waits in C (a collective, a
compile) past the limit and a further GRACE seconds ends its worker with
every thread's traceback instead of hanging it."""

import faulthandler
import os
import signal

import pytest

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers:
    import torch
    _cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    torch.set_num_threads(max(1, _cpus // _workers))

TIME_LIMIT = 300.0
GRACE = 60.0

_armed = {}


def _overrun(signum, frame):
    pytest.fail(f"{_armed['what']} overran its time limit of "
                f"{_armed['seconds']:g} s")


def _arm(what):
    _armed.update(what=what, seconds=TIME_LIMIT)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT)
    faulthandler.dump_traceback_later(TIME_LIMIT + GRACE, exit=True)


@pytest.fixture(scope="module", autouse=True)
def module_time_limit(request):
    """The limit's handler for the module's tests, and the limit of the
    first test's setup: autouse, it is made before the module's other
    fixtures of its scope."""
    prev = signal.signal(signal.SIGALRM, _overrun)
    _arm(f"setup of {request.module.__name__}")
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    faulthandler.cancel_dump_traceback_later()
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def time_limit(request, module_time_limit):
    """A limit for the test's call, then one for its teardown and the next
    test's setup, up to this fixture's next use (or the module's end)."""
    _arm(request.node.nodeid)
    yield
    _arm(f"teardown of {request.node.nodeid} or the next test's setup")
