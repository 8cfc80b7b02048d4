"""Structured metrics and logging (counterpart of
nx_signal_tpu/utils/metrics.py): counters, timers, a throughput meter,
and one JSON line per event."""

import json
import sys
import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

__all__ = ["Metrics", "ThroughputMeter", "log_event"]


def log_event(event: str, *, stream=None, **fields):
    """Emit one structured JSON log line: {"event", "ts", **fields}.
    Values must be JSON-serializable: cast device scalars with float() or
    int() first, which syncs on a CUDA tensor, and never log a live
    tensor.

    Examples:

    >>> import io, json
    >>> from nx_signal_tpu_torch.utils.metrics import log_event
    >>> buf = io.StringIO()
    >>> log_event('bench', stream=buf, chip='H100')
    >>> rec = json.loads(buf.getvalue())
    >>> rec['event'], rec['chip'], 'ts' in rec
    ('bench', 'H100', True)
    """
    rec = {"event": event, "ts": round(time.time(), 3)}
    rec.update(fields)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)


class Metrics:
    """Named counter/gauge/timer registry with JSON snapshots.

    Counters accumulate (`count`), gauges overwrite (`gauge`), timers
    accumulate host-clock seconds and call counts (`timer` context
    manager; time device work with a sync inside it). `emit` prints one
    structured line via `log_event`; `snapshot` returns the plain dict.

    Examples:

    >>> from nx_signal_tpu_torch.utils.metrics import Metrics
    >>> m = Metrics()
    >>> m.count('frames', 3)
    >>> m.gauge('lag_s', 0.5)
    >>> with m.timer('step'):
    ...     pass
    >>> s = m.snapshot()
    >>> s['frames'], s['lag_s'], s['step_calls']
    (3, 0.5, 1)
    """

    def __init__(self):
        self._counters = {}
        self._gauges = {}
        self._timers = {}  # name -> [seconds, calls]

    def count(self, name: str, value=1):
        self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value):
        self._gauges[name] = value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            sec, calls = self._timers.get(name, (0.0, 0))
            self._timers[name] = (sec + dt, calls + 1)

    def snapshot(self) -> dict:
        out = {}
        for k, v in self._counters.items():
            out[k] = v
        for k, v in self._gauges.items():
            out[k] = v
        for k, (sec, calls) in self._timers.items():
            out[f"{k}_seconds"] = round(sec, 6)
            out[f"{k}_calls"] = calls
        return out

    def emit(self, event: str = "metrics", *, stream=None, **extra):
        log_event(event, stream=stream, **self.snapshot(), **extra)


def _chips() -> int:
    """The world size of an initialised process group, else the CUDA
    devices; never the CPU."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if torch.cuda.device_count():
        return torch.cuda.device_count()
    raise RuntimeError("ThroughputMeter: no process group and no CUDA device to count; "
                       "pass n_devices=")


class ThroughputMeter:
    """samples/s, Msamples/s/chip and scaling-efficiency accounting. Feed
    it (samples, seconds) per timed step; it reports simple totals over a
    run. `n_devices=None` counts the world size of an initialised process
    group, else the CUDA devices; with neither it raises (a CPU is never
    counted as a chip).

    `scaling_efficiency(single_chip_msps)` is per-chip throughput divided
    by a single-chip baseline.

    Examples:

    >>> from nx_signal_tpu_torch.utils.metrics import ThroughputMeter
    >>> tm = ThroughputMeter(n_devices=2)
    >>> tm.update(1_000_000, 0.5)
    >>> tm.samples_per_second, tm.msamples_per_second_per_chip
    (2000000.0, 1.0)
    >>> tm.scaling_efficiency(1.25)   # vs a 1.25 Ms/s/chip single-chip run
    0.8
    """

    def __init__(self, n_devices=None):
        self.n_devices = n_devices if n_devices is not None else _chips()
        self.samples = 0
        self.seconds = 0.0

    def update(self, samples: int, seconds: float):
        self.samples += int(samples)
        self.seconds += float(seconds)

    @property
    def samples_per_second(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0

    @property
    def msamples_per_second_per_chip(self) -> float:
        return self.samples_per_second / self.n_devices / 1e6

    def scaling_efficiency(self, single_chip_msamples_per_s: float) -> float:
        return self.msamples_per_second_per_chip / single_chip_msamples_per_s

    def snapshot(self) -> dict:
        return {
            "samples": self.samples,
            "seconds": round(self.seconds, 6),
            "samples_per_second": round(self.samples_per_second, 1),
            "msamples_per_second_per_chip": round(
                self.msamples_per_second_per_chip, 3),
            "devices": self.n_devices,
        }
