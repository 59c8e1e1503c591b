"""Machine probes of the card (the reference's minibench/ layer): the
counterpart of ``tools/minibench.py``.

  matmul       ← flop-test.c: f32 ``torch.matmul`` at 4096³ with TF32 off
                 (FFMA), and bf16 (tensor cores), in TF/s
  hbm          ← bandwidth-test.c: ``v * 1.0001 + 1.0`` over 512 MB, one
                 read and one write an element, in GB/s
  dispatch     ← kernel-test.c: the round trip of a tiny op and ``.item()``
  interconnect ← gpu-bandwidth.c: an NCCL ``all_gather`` over the cards,
                 one process a card (``parallel.launch.spawn``); with one
                 card the probe says so
  compile_cost ← module-test.c: a cold ``nvcc`` build of one kernel source
                 with the kernels' flags, against a load of the built
                 library from its hash-keyed cache
  timer        ← timer.c / event.c: does ``torch.cuda.synchronize()``
                 wait? A host-clock time around a call and a synchronize
                 against the call's CUDA-event time; and how many short
                 ``torch.profiler`` windows show their kernel
  flop_word    ← flop-word.c: f32 flops per f32 word moved, from the two
                 rates above

    python -m cholesky_tpu_torch.tools.minibench   (prints one JSON object)

Card only: without a card it exits non-zero and prints no JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import cholesky_tpu_torch  # noqa: F401  (TF32 off)
from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.benchlib import bench_op, card
from cholesky_tpu_torch.utils.profiling import (GUARD_LAUNCHES, LostKernels,
                                                device_time)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def probe_matmul(n=4096):
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn(n, n, device="cuda", generator=g)
    B = torch.randn(n, n, device="cuda", generator=g)
    t32 = bench_op(lambda x: torch.matmul(x, B), A, reps=6)
    Ab, Bb = A.bfloat16(), B.bfloat16()
    tb = bench_op(lambda x: torch.matmul(x, Bb), Ab, reps=6)
    return {"f32_tflops": round(2 * n ** 3 / t32 / 1e12, 1),
            "bf16_tflops": round(2 * n ** 3 / tb / 1e12, 1)}


def probe_hbm(mb=512):
    n = int(mb * 1024 * 1024 // 4)
    x = torch.randn(n, device="cuda")
    # v * 1.0001 + 1.0 as ONE vectorized kernel, 1 + 1.0001·v with the 1
    # a CPU scalar: eager ``v * a + b`` is two kernels, each reading and
    # writing the whole vector, and a 0-dim CUDA tensor would be a
    # broadcast operand, read through the kernel's unvectorized path
    one = torch.tensor(1.0)
    t = bench_op(lambda v: torch.add(one, v, alpha=1.0001), x, reps=8)
    # one read + one write per element
    return {"stream_gbps": round(2 * n * 4 / t / 1e9, 1)}


def probe_dispatch(k=20):
    x = torch.zeros((8, 128), device="cuda")
    (x + 1.0).sum().item()
    t0 = time.perf_counter()
    for _ in range(k):
        (x + 1.0).sum().item()     # a full round trip each call
    return {"roundtrip_ms": round((time.perf_counter() - t0) / k * 1e3, 3)}


def _gather_rank(rank, mb):
    """One rank of the interconnect probe: median seconds of an
    all_gather of an mb-MB shard a rank (CUDA events)."""
    import torch.distributed as dist
    n = int(mb * 1024 * 1024 // 4)
    world = dist.get_world_size()
    x = torch.full((n,), float(rank), device="cuda")
    out = torch.empty(world * n, device="cuda")
    return bench_op(lambda v: dist.all_gather_into_tensor(out, v), x, reps=8)


def probe_interconnect(mb=64):
    """NCCL all_gather bandwidth a card over every card of this machine."""
    ndev = torch.cuda.device_count()
    if ndev < 2:
        return {"unavailable": "single card — interconnect bandwidth "
                               "cannot be measured on this machine",
                "device_kind": torch.cuda.get_device_name(0),
                "n_devices": 1}
    from cholesky_tpu_torch.parallel import launch
    t = max(launch.spawn(ndev, _gather_rank, mb, backend="nccl"))
    # each card receives (ndev-1)/ndev of the full array
    moved = (ndev - 1) * int(mb * 1024 * 1024 // 4) * 4
    return {"all_gather_gbps_per_card": round(moved / t / 1e9, 1),
            "n_devices": ndev}


def probe_compile_cost(source="prng.cu"):
    """A cold nvcc build of one kernel source (an object file in a new
    directory, the kernels' flags) against loading the built library
    from the hash-keyed cache (``_build.build()`` once it is built)."""
    first = _build.build()       # builds every source when not yet built
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
               str(Path(tmp) / "probe.o"), str(_build.CSRC / source)]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True)
        cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.build()
    cached = time.perf_counter() - t0
    return {"source": source, "cold_nvcc_s": round(cold, 2),
            "cached_load_s": round(cached, 4),
            "library_build_s": round(first.seconds, 2)}


def probe_timer(n=4096, windows=10):
    """Does torch.cuda.synchronize() wait for the card? The host clock
    around a call and a synchronize must cover the call's CUDA-event
    time; the host clock around the launch alone does not (the
    asynchronous-launch trap). And does torch.profiler see the kernels of
    a short window? Of ``windows`` profiled calls, each one attempt behind
    the first entry of GUARD_LAUNCHES, those whose census holds a kernel
    (a window that lost it raises LostKernels)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    A = torch.randn(n, n, device="cuda", generator=g)
    t_event = bench_op(lambda x: torch.matmul(x, x), A, reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.matmul(A, A)
    t_launch = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_sync = time.perf_counter() - t0

    def kept():
        try:
            return device_time(lambda: torch.matmul(A, A),
                               guards=GUARD_LAUNCHES[:1])["busy"][1] > 0
        except LostKernels:
            return False

    seen = sum(kept() for _ in range(windows))
    return {"event_ms": round(t_event * 1e3, 3),
            "synchronize_ms": round(t_sync * 1e3, 3),
            "launch_only_ms": round(t_launch * 1e3, 3),
            "block_is_trustworthy": bool(t_sync > 0.5 * t_event),
            "profiled_windows_with_kernel": [seen, windows]}


def flop_word(f32_tflops: float, stream_gbps: float) -> float:
    """f32 flops per f32 word (4 bytes) moved: the matmul rate over the
    streaming rate."""
    return round(f32_tflops * 1e3 / (stream_gbps / 4), 1)


def run() -> dict:
    """Every probe on card 0, as one dict."""
    props = torch.cuda.get_device_properties(0)
    out = {"device": card(), "sm_count": props.multi_processor_count}
    for name, probe in (("matmul", probe_matmul), ("hbm", probe_hbm),
                        ("dispatch", probe_dispatch),
                        ("interconnect", probe_interconnect),
                        ("compile_cost", probe_compile_cost),
                        ("timer", probe_timer)):
        log(f"probing {name} ...")
        out[name] = probe()
    out["flop_word"] = flop_word(out["matmul"]["f32_tflops"],
                                 out["hbm"]["stream_gbps"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("minibench: no CUDA card (torch.cuda.is_available() is false)")
        return 1
    print(json.dumps(run(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
