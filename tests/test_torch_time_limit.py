"""The per-test time limit of tests/torch_limits.py. One child pytest, its
limit set to 1 s by its own conftest, runs a file of three tests: one that
sleeps 3 s, which must fail with its limit named; one that returns at once,
which must pass; and one whose module fixture, made in its setup, sleeps
3 s, which must fail in that setup."""

import os
import signal
import subprocess
import sys

import pytest

from tests import torch_limits
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFTEST = """
from tests import torch_limits

torch_limits.TIME_LIMIT = 1.0
"""

CHILD = """
import signal
import time

import pytest

from tests.torch_limits import module_time_limit, time_limit  # noqa: F401


@pytest.fixture(scope="module")
def slow_world():
    time.sleep(3)


def test_sleeps_past_its_limit():
    time.sleep(3)


def test_fast():
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= 1


def test_on_a_slow_world(slow_world):
    pass
"""


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    root = tmp_path_factory.mktemp("time_limit")
    (root / "conftest.py").write_text(CONFTEST)
    (root / "test_child.py").write_text(CHILD)
    # a plain child: no xdist worker's settings, no plugins
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST")}
    env.update(PYTHONPATH=REPO, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    # the child takes about 8 s
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-q",
         "-rA", "test_child.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=60)


def test_overrun_fails_with_its_limit(child):
    assert child.returncode == 1, child.stdout + child.stderr
    assert "FAILED test_child.py::test_sleeps_past_its_limit" in child.stdout
    assert ("Failed: test_child.py::test_sleeps_past_its_limit overran its "
            "time limit of 1 s") in child.stdout, child.stdout


def test_a_fast_test_passes_under_the_limit(child):
    assert "PASSED test_child.py::test_fast" in child.stdout, child.stdout
    assert "1 failed, 1 passed, 1 error" in child.stdout, child.stdout
    # and this one, in this process, under the default
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= torch_limits.TIME_LIMIT == 300.0


def test_a_module_fixture_made_later_runs_under_the_limit(child):
    assert "ERROR test_child.py::test_on_a_slow_world" in child.stdout
    assert ("Failed: teardown of test_child.py::test_fast or the next "
            "test's setup overran its time limit of 1 s") in child.stdout, \
        child.stdout
