"""The program's own spans over a traced window (``profiling.collect`` of
``cholesky_tpu_torch/utils/profiling.py``), and what the span metrics
read from them.

Each reader's ``Probe`` opens the program's collector over the window;
collectors nest and share one list. A span's layer is its name's part
before the first dot: ``gp`` the model, ``api`` and ``blocked`` the API
and dispatch, ``driver`` the blocked drivers, ``kernel`` the kernel
wrappers. A span's host self time is its duration less that of its
direct children, so that the self times of a call's spans add up to its
root's duration. A program without the collector (one older than its
spans) gives no list, and every reader then returns None.
"""

from collections import defaultdict

LAYERS = {"gp": "model", "api": "api", "blocked": "api",
          "driver": "driver", "kernel": "launch"}


def layer(name):
    return LAYERS.get(name.split(".", 1)[0])


class Probe:
    """The program's collector, open over the window; ``spans`` stays None
    where the program has none. ``device``: the prefixes of the span names
    whose CUDA-event pairs a reader reads (each pair queues two records on
    the card, so a probe asks for no more)."""
    device = ()

    def __init__(self):
        from cholesky_tpu_torch.utils import profiling

        self.collect = getattr(profiling, "collect", None)
        self.spans, self._open = None, None

    def __enter__(self):
        if self.collect is not None:
            self._open = self.collect(device=self.device)
            self.spans = self._open.__enter__()
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            self._open.__exit__(*exc)
        return False

    def before_call(self):
        pass

    def after_call(self):
        pass


def spans_of(run, metric):
    """The window's spans as the probe of ``metric`` kept them, or None."""
    probe = run.probes.get(metric)
    return None if probe is None else probe.spans


def self_ns(spans):
    """{span id: host self time in ns}."""
    inner = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.host_ns
    return {s.id: s.host_ns - inner[s.id] for s in spans}


def host_ms_per_call(spans, of_layer, calls):
    """Mean host self time per call of the spans of one layer, in ms;
    None where the window holds no such span."""
    own = self_ns(spans)
    mine = [own[s.id] for s in spans if layer(s.name) == of_layer]
    if not mine or not calls:
        return None
    return sum(mine) / 1e6 / calls


def model_device_ms(spans):
    """Mean over the ``gp.*`` roots of their device ms less that of their
    outermost ``api.*`` spans; None without such a root timed."""
    in_api, outside = {}, {}
    for s in spans:
        api = s.name.startswith("api.")
        up = in_api.get(s.parent, False)
        if s.parent is None and s.name.startswith("gp."):
            outside[s.id] = s.device_ms()
        elif api and not up and outside.get(s.call) is not None:
            outside[s.call] -= s.device_ms()
        in_api[s.id] = api or up
    timed = [v for v in outside.values() if v is not None]
    return sum(timed) / len(timed) if timed else None


def path_roofline(spans, kernel, ops, nbytes, peaks):
    """Percent of the roofline that the window's launches of ``kernel``
    reach together: the sum over launches of max(ops / peak rate, bytes /
    memory rate), each from the launch's recorded attributes
    (``ops(attrs)``, ``nbytes(attrs)``), over the sum of their device
    times; None without a timed launch or without the card's peaks."""
    if peaks is None:
        return None
    name = f"kernel.{kernel}"
    bound_s = ms = 0.0
    for s in spans:
        t = s.device_ms() if s.name == name else None
        if t is not None:
            bound_s += max(ops(s.attrs) / peaks["f32_flops_per_s"],
                           nbytes(s.attrs) / peaks["hbm_bytes_per_s"])
            ms += t
    return 100.0 * bound_s / (ms / 1e3) if ms > 0.0 else None
