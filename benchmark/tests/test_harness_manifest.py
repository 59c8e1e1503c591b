"""BENCHMARK.json against the contract it is checked by, every cell
resolved to its files, and the traffic and inputs repeatable from the
seed."""

import re

import pytest
import torch

from benchmark import harness, inputs, traffic

M = harness.read_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in M["workloads"]]
E2E = {m["name"]: m for m in M["end_to_end"]}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (harness.ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(M["command"]) <= 32 and all(one_line(w) for w in M["command"])
    files = [w for w in M["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in M["paths"])
                         for f in files)


def test_names_units_sources():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in M[group]]
        assert len(names) == len(set(names))
        assert all(NAME.fullmatch(n) for n in names)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in M["end_to_end"])


def test_bounds():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] == 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_run_seconds_fit_the_full_check():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["name"] in used and one_line(c["why"])
        assert one_line(c["source"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.fullmatch(w["traffic"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.resolve(name)
    assert hasattr(harness.load("calls", cell.mix["call"]), "Call")
    assert "failed_calls" in cell.limits
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]).read)


def test_per_layer_metrics():
    for m in M["per_layer"]:
        assert one_line(m["layer"]) and m["moves"] in E2E
        cells = m.get("workloads", CELLS)
        assert set(cells) <= set(CELLS)
        # each cell that reports it reports the metric it moves
        moved = E2E[m["moves"]].get("workloads", CELLS)
        assert set(cells) <= set(moved)
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


def test_every_mix_is_a_data_file():
    for w in M["workloads"]:
        mix = harness.read_json(harness.BENCH / "workloads"
                                / f"{w['traffic']}.json")
        assert (harness.BENCH / "calls" / f"{mix['call']}.py").exists()


def test_sweep_sizes():
    mix = harness.resolve("spotrf-sweep-64-4096").mix
    assert traffic.sizes(mix, {}) == list(range(64, 4097, 64))
    assert traffic.sizes({"sizes": [16384]}, {}) == [16384]
    assert traffic.sizes({}, {"n": 8192}) == [8192]


SEED = 2 ** 31 + 12345


def test_inputs_repeat_under_a_seed_and_differ_under_another():
    def make(seed):
        g = inputs.generator(seed, "cpu")
        A = inputs.dense_spd(g, 64, 100.0, torch.float32, "cpu")
        X, y = inputs.gp_data(g, 32, 8, torch.float32, "cpu")
        Xs = inputs.gp_test_points(g, 2, 5, 8, torch.float32, "cpu")
        return A, X, y, Xs

    same, again, other = make(SEED), make(SEED), make(SEED + 1)
    assert all(torch.equal(a, b) for a, b in zip(same, again))
    assert not any(torch.equal(a, b) for a, b in zip(same, other))
    A = same[0]
    assert torch.equal(A, A.T)
    assert float(torch.linalg.eigvalsh(A.double()).min()) > 0


def test_the_sample_is_drawn_from_the_seed():
    def kept(seed):
        s = harness.Sample(4, seed)
        for i in range(1000):
            s.offer(i, i)
        return sorted(s.kept)

    assert kept(SEED) == kept(SEED)
    assert kept(SEED) != kept(SEED + 1)
    assert len(kept(SEED)) == 4
