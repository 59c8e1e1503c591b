"""The check can fail: the control (the reference in TF32 put in the
program's place) and every fault a cell's entry point can have make a
run's ``correct`` false, and a sound run's true. Runs on the CPU at sizes
a test run holds, skipping the harness's look for a card and driving the
rest of a run; the limits are the cells' own."""

import pytest

from benchmark import compare, faults, harness, readings

SEED = 2 ** 31 + 99
#: each cell at a size the CPU holds: (configuration's keys, mix's keys)
SMALL = {
    "gp-kin8nm-train": ({"n": 512}, {}),
    "gp-kin8nm-predict": ({"n": 1024, "m": 31}, {"pool": 4}),
    "spotrf-16384": ({}, {"sizes": [1024]}),
    "spotrf-sweep-64-4096": ({}, {"sizes": {"from": 64, "to": 1024,
                                            "step": 320}}),
}


def small(name):
    cell = harness.resolve(name)
    config, mix = SMALL[name]
    cell.config.update(config)
    cell.mix.update(mix)
    return cell


def run(cell):
    return harness.run(cell, SEED, 0.2, False, device="cpu")


def test_every_cell_has_a_small_size():
    assert set(SMALL) == {w["name"] for w in harness.read_json(
        harness.ROOT / "BENCHMARK.json")["workloads"]}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    r = run(small(name))
    assert r["correct"], r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks" and r["attempted"] > 0
    assert set(r["checks"]) == set(small(name).limits)


@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in sorted(SMALL)
    for fault in faults.FAULTS[harness.resolve(name).mix["call"]]])
def test_a_fault_makes_the_run_incorrect(name, fault):
    cell = small(name)
    with faults.plant(cell.mix["call"], fault):
        r = run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(name):
    cell = small(name)
    got = readings.reading(cell, SEED, "cpu", control=True, seconds=0.2)
    ok, checks = compare.judge({**got["control"], "failed_calls": 0.0},
                               cell.limits)
    assert not ok, checks
    # and the program, on the same sampled calls, is correct
    assert compare.judge(got["program"], cell.limits)[0]
