"""One run of one cell of ``BENCHMARK.json``, driven by data.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``workloads/<traffic>.json``); the mix names the entry point it
drives (``calls/<call>.py``); each metric is a reader of its own
(``metrics/<metric>.py``, see :func:`reader`), and each cell's check
has its limits (``limits/<cell>.json``). Nothing here names a cell, a configuration or a
metric.

A run: set-up (inputs from the seed, every shape warmed), then with
``--trace 1`` a short profiled sub-window, then the measured window: a
closed loop in which one caller issues the next call once it has read
the last call's ``info``. After the window: the peak memory, the check
that no JAX module was loaded, the metrics, and the comparison of a
sample of the window's answers, drawn from the seed, with the reference.
"""

import contextlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that no benchmark run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "cholesky_tpu")
#: seconds of the profiled sub-window of a traced run
CENSUS_SECONDS = 1.0


def load(kind, name):
    """The module ``<kind>/<name>.py`` of the benchmark, by its file (a
    name may hold dots and hyphens)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric):
    """The reader of a metric: ``metrics/<name>.py``, where a qualifier
    after the first dot names the cells a metric is split for
    (``mfu.sweep`` is read by ``metrics/mfu.py``)."""
    return load("metrics", metric.split(".")[0])


def read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def resolve(name, manifest=None):
    """The cell ``name`` of the manifest with its files read."""
    m = manifest or read_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg = {c["name"]: c for c in m["configs"]}[w["config"]]

    def mine(metrics):
        return [x for x in metrics if name in x.get("workloads", [name])]

    return Cell(name, w["chips"], read_json(ROOT / cfg["file"]),
                read_json(BENCH / "workloads" / f"{w['traffic']}.json"),
                read_json(BENCH / "limits" / f"{name}.json"),
                mine(m["end_to_end"]), mine(m["per_layer"]))


class Sample:
    """A reservoir of ``k`` of the window's answers, drawn from the seed:
    every answer due in the window is as likely to be kept."""

    def __init__(self, k, seed):
        self.k, self.rng = k, random.Random(seed)
        self.slots, self.seen = [], 0

    def offer(self, i, answer):
        if answer is None:
            return
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append((i, answer))
        elif (j := self.rng.randrange(self.seen)) < self.k:
            self.slots[j] = (i, answer)

    @property
    def kept(self):
        return dict(self.slots)


@dataclass
class Window:
    seconds: float = 0.0
    calls: int = 0
    failed: int = 0
    flops: float = 0.0
    call_s: list = field(default_factory=list)   # entry to info read
    host_s: list = field(default_factory=list)   # entry to return


class Loop:
    """The closed loop over one cell's calls: call i + 1 is issued once
    call i's info has been read, as a caller of a LAPACK routine waits
    for it. ``i`` runs on across set-up, sub-window and window."""

    def __init__(self, call, sample):
        self.call, self.sample, self.i = call, sample, 0

    def run_for(self, seconds, probes=(), span=None):
        w = Window()
        t0 = time.perf_counter()
        while (ts := time.perf_counter()) - t0 < seconds:
            with span() if span else contextlib.nullcontext():
                for p in probes:
                    p.before_call()
                answer, info = self.call.run(self.i)
                th = time.perf_counter()
                for p in probes:
                    p.after_call()
                failed = int(info) != 0
            te = time.perf_counter()
            w.call_s.append(te - ts)
            w.host_s.append(th - ts)
            w.flops += self.call.flops(self.i)
            w.failed += failed
            w.calls += 1
            self.sample.offer(self.i, answer)
            self.i += 1
        w.seconds = time.perf_counter() - t0
        return w

    def prime(self, k):
        """k calls whose answers are held together and then dropped, so
        that the allocator's cache holds room for the answers the window
        keeps."""
        held = [self.call.run(self.i + j) for j in range(k)]
        for _, info in held:
            int(info)
        self.i += k


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    seed: int
    device: str
    call: object
    window: Window
    setup_s: float
    launches: dict
    census: dict = None
    probes: dict = field(default_factory=dict)
    peaks: dict = None


def loaded_forbidden():
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout else out.stderr


def prepare(cell, seed, device):
    """Set-up's inputs and warm calls: the cell's call object, warmed."""
    call = load("calls", cell.mix["call"]).Call(cell.config, cell.mix, seed,
                                                device)
    call.warm()
    return call


def check(cell, call, kept, failed):
    """(correct, checks) of a run whose window kept ``kept`` and saw
    ``failed`` calls fail."""
    from benchmark import compare

    numbers = call.numbers(kept)
    numbers["failed_calls"] = float(failed)
    return compare.judge(numbers, cell.limits)


def _sync(device):
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def run(cell, seed, seconds, trace, device="cuda", t_start=None):
    """One run: the result's dict, or None where a forbidden module was
    loaded (named on standard error)."""
    import torch

    from cholesky_tpu_torch.ops.kernels import launch_counts

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    call = prepare(cell, seed, device)
    sample = Sample(cell.mix.get("sample", 1), seed)
    loop = Loop(call, sample)
    loop.prime(sample.k)
    _sync(device)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: reader(m["name"]) for m in metrics}
    census = None
    if trace and cuda:
        from torch.profiler import record_function

        from benchmark import census as census_mod

        census = census_mod.measure(lambda: loop.run_for(
            CENSUS_SECONDS, span=lambda: record_function(census_mod.CALL)))
        if census is None:
            raise RuntimeError("torch.profiler lost kernels of the census "
                               "window behind every count of guards")
    probes = {name.split(".")[0]: r.Probe() for name, r in readers.items()
              if trace and cuda and hasattr(r, "Probe")}
    before = launch_counts()
    setup_s = time.perf_counter() - t_start
    with contextlib.ExitStack() as stack:
        for p in probes.values():
            stack.enter_context(p)
        window = loop.run_for(seconds, probes.values())
    _sync(device)
    after = launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = loaded_forbidden()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return None

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    peaks = read_json(BENCH / "peaks.json").get(device_info["kind"])
    r = Run(cell, seed, device, call, window, setup_s,
            {k: after[k] - before[k] for k in after}, census, probes, peaks)
    values = {name: rd.read(r) for name, rd in readers.items()}
    out = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
           for m in metrics if values[m["name"]] is not None}
    if census is not None:
        device_info["busy_s"] = census["busy_s"]
        device_info["window_s"] = census["window_s"]

    kept = sample.kept
    del loop, sample, r, probes
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = check(cell, call, kept, window.failed)
    result = {"correct": correct, "attempted": window.calls,
              "failed": window.failed, "metrics": out, "device": device_info}
    if census is not None:
        result["breakdown"] = {"device_ops": census["device_ops"],
                               "idle_gaps": census["idle_gaps"]}
    result["card"] = card() if cuda else "cpu"
    result["checks"] = checks
    return result


def main(args, t_start):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 t_start)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0
