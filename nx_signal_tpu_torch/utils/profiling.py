"""Performance measurement and roofline accounting (counterpart of
nx_signal_tpu/utils/profiling.py) on PyTorch: CUDA events and
torch.cuda.synchronize on a card, the host clock on the CPU, and
torch.profiler traces, in which the port's own spans (`span`) name its
parts.

The JAX package's scalar-fetch barrier (a workaround for a remote-attached
TPU backend) and its TPU bandwidth table have no counterpart here: a
CUDA sync is complete, and the bandwidth table holds the cards' own data
sheet figures.
"""

import contextlib
import math
import os
import time
from dataclasses import dataclass

import torch

from nx_signal_tpu_torch.utils.devices import target_device

__all__ = ["benchmark", "BenchResult", "device_hbm_bandwidth", "hard_sync",
           "trace", "timed_median", "slope_rate"]

# device-memory bandwidth in bytes/s from NVIDIA's data sheets, keyed by a
# part of torch.cuda.get_device_name
_HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,  # H100 SXM
    "H100 PCIe": 2.0e12,
}


def device_hbm_bandwidth(device=None) -> float:
    """Device-memory bandwidth in bytes/s of a CUDA card (default: the
    current one), from NVIDIA's data sheet for that card. A CPU device or
    a card missing from the table raises, naming it.

    Examples:

    >>> from nx_signal_tpu_torch.utils.profiling import device_hbm_bandwidth
    >>> device_hbm_bandwidth("cpu")
    Traceback (most recent call last):
    ...
    ValueError: device_hbm_bandwidth: cpu has no device-memory figure; it reads a CUDA card's
    """
    device = target_device(device)
    if device.type != "cuda":
        raise ValueError(f"device_hbm_bandwidth: {device} has no device-memory figure; "
                         "it reads a CUDA card's")
    name = torch.cuda.get_device_name(device)
    for key, bw in _HBM_BYTES_PER_S.items():
        if key in name:
            return bw
    raise ValueError(f"device_hbm_bandwidth: no bandwidth figure for {name!r} "
                     f"(the table holds {sorted(_HBM_BYTES_PER_S)})")


@dataclass(frozen=True)
class BenchResult:
    """Result of `benchmark`: wall time per call plus the derived
    throughput and fraction of the device-memory bound (0 when the caller
    gave no samples/bytes model).

    Examples:

    >>> from nx_signal_tpu_torch.utils.profiling import BenchResult
    >>> str(BenchResult(0.002, 5e8, 0.25))
    '2.000 ms/call, 500 Msamples/s, 25.0% of HBM SoL'
    """

    seconds_per_call: float
    samples_per_second: float  # 0 when samples_per_call not given
    hbm_fraction: float        # fraction of speed-of-light, 0 when unknown

    def __str__(self):
        parts = [f"{self.seconds_per_call * 1e3:.3f} ms/call"]
        if self.samples_per_second:
            parts.append(f"{self.samples_per_second / 1e6:.0f} Msamples/s")
        if self.hbm_fraction:
            parts.append(f"{self.hbm_fraction * 100:.1f}% of HBM SoL")
        return ", ".join(parts)


def _tensors(out):
    """The tensors of a (nested tuple, list or dict) result."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _cuda_devices(out):
    return sorted({t.device for t in _tensors(out) if t.device.type == "cuda"},
                  key=lambda d: d.index)


def hard_sync(out):
    """Completion barrier: torch.cuda.synchronize on each CUDA device that
    holds a tensor of `out` (a tensor or a nested tuple, list or dict);
    nothing for CPU tensors.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.profiling import hard_sync
    >>> hard_sync(torch.ones(4) * 2.0)   # returns once the result exists
    """
    for device in _cuda_devices(out):
        torch.cuda.synchronize(device)


def benchmark(fn, *args, iters: int = 10, samples_per_call: int = 0,
              min_bytes_per_sample: float = 0.0) -> BenchResult:
    """Time `fn(*args)` as it is: two warm-up calls, then `iters` calls
    back to back and one `hard_sync` of the last result, on the host
    clock. The second warm-up call runs while the first one's result is
    alive, as each timed call does while its predecessor's is, so the
    caching allocator's growth to two results (a cudaMalloc of the
    result's size) falls outside the timing.
    When `samples_per_call` and `min_bytes_per_sample` are given, also
    reports throughput as a fraction of the device-memory bound of the
    card holding the result (`device_hbm_bandwidth`; a CPU result
    raises).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.profiling import benchmark
    >>> r = benchmark(lambda x: x * 2.0, torch.ones(1024), iters=2, samples_per_call=1024)
    >>> r.seconds_per_call > 0.0, r.samples_per_second > 0.0, r.hbm_fraction
    (True, True, 0.0)
    """
    out = fn(*args)
    out = fn(*args)
    hard_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    hard_sync(out)
    dt = (time.perf_counter() - t0) / iters
    sps = samples_per_call / dt if samples_per_call else 0.0
    frac = 0.0
    if samples_per_call and min_bytes_per_sample:
        devices = _cuda_devices(out)
        bandwidth = device_hbm_bandwidth(devices[0] if devices else "cpu")
        frac = sps * min_bytes_per_sample / bandwidth
    return BenchResult(dt, sps, frac)


def timed_median(fn, *args, steps: int = 8, reps: int = 5) -> float:
    """Median per-step seconds of `fn(*args)` with pipelined dispatch: each
    rep issues `steps` back-to-back calls, timed by CUDA events around
    them on the stream of the card that holds the result, or by the host
    clock and a `hard_sync` on the CPU. The warm-up call before the reps
    is not timed.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.profiling import timed_median
    >>> timed_median(lambda x: x * 2.0, torch.ones(256), steps=2, reps=2) > 0.0
    True
    """
    out = fn(*args)
    hard_sync(out)
    devices = _cuda_devices(out)
    times = []
    for _ in range(reps):
        if devices:
            stream = torch.cuda.current_stream(devices[0])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(steps):
                out = fn(*args)
            end.record(stream)
            hard_sync(out)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / steps)
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                out = fn(*args)
            hard_sync(out)
            times.append((time.perf_counter() - t0) / steps)
    return sorted(times)[len(times) // 2]


def slope_rate(work_delta: float, dt_small: float, dt_large: float) -> float:
    """Differential (marginal) rate between two problem sizes measured in
    one process: work_delta / (dt_large - dt_small), which cancels the
    fixed per-call cost. Size the large case at >= 2x the small one so the
    marginal work exceeds the timing jitter. Where the timings are
    inverted (dt_large <= dt_small) the rate is NaN; the JAX package
    clamps the denominator to 1e-12 there and returns a huge rate.

    Examples:

    >>> from nx_signal_tpu_torch.utils.profiling import slope_rate
    >>> slope_rate(8e9, 0.010, 0.020)   # 8 GB extra moved in 10 ms more
    800000000000.0
    >>> slope_rate(8e9, 0.020, 0.010)
    nan
    """
    if not dt_large > dt_small:
        return math.nan
    return work_delta / (dt_large - dt_small)


@contextlib.contextmanager
def trace(path: str):
    """Context manager that profiles its body with torch.profiler (CPU
    activity, and CUDA activity where a card is present) and writes a
    Chrome trace to `path`/trace.json (view it in Perfetto or
    chrome://tracing); yields the profiler.

    Examples:

    >>> import os, tempfile, torch
    >>> from nx_signal_tpu_torch.utils.profiling import trace
    >>> path = tempfile.mkdtemp()
    >>> with trace(path):
    ...     _ = torch.ones(16) * 2.0
    >>> os.path.exists(os.path.join(path, "trace.json"))
    True
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the port's own (`nx.chain`, `nx.weights.a_tc`, ...)
    for the profiler's trace: while torch.profiler records, a
    `torch.profiler.record_function(name)`, which the Chrome trace shows as
    a `user_annotation` event on the same clock as the card's kernels; with
    no profiler, one shared null context, so a span costs about a
    microsecond and makes no RecordFunction.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.profiling import span
    >>> span("nx.example") is span("nx.other")   # no profiler: the shared null context
    True
    >>> with torch.profiler.profile() as prof:
    ...     with span("nx.example"):
    ...         _ = torch.ones(4) * 2.0
    >>> any(e.name == "nx.example" for e in prof.events())
    True
    """
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
