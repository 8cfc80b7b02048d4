"""The port's utils (nx_signal_tpu_torch/utils/checks.py, metrics.py and
profiling.py) against the JAX package's, on the CPU: the counts and
messages of the checks, the metrics' snapshots and log lines, the rates of
`slope_rate` (the JAX package's, except NaN where the timings are
inverted), and the device rules the port adds (a CPU is never a chip, and
a CPU has no device-memory figure)."""

import io
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nx_signal_tpu.utils import checks as jchecks
from nx_signal_tpu.utils import metrics as jmetrics
from nx_signal_tpu.utils import profiling as jprof
from nx_signal_tpu_torch.utils import checks, metrics, profiling

ARRAYS = {
    "float": np.array([1.0, np.inf, np.nan, -np.inf, 2.0], np.float32),
    "finite": np.arange(6.0).reshape(2, 3),
    "complex": np.array([1 + 1j, complex(np.nan, 0.0), complex(1.0, np.inf),
                         complex(np.inf, np.nan)], np.complex64),
    "int": np.arange(5, dtype=np.int32),
    "empty": np.zeros(0, np.float32),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_count_nonfinite(name):
    x = ARRAYS[name]
    got = checks.count_nonfinite(torch.from_numpy(x))
    assert got.dtype == torch.int64 and got.shape == () and got.device.type == "cpu"
    assert int(got) == int(jchecks.count_nonfinite(jnp.asarray(x)))


def test_assert_all_finite(monkeypatch):
    x = torch.arange(4.0)
    assert checks.assert_all_finite(x, "spectrum") is x
    bad = ARRAYS["float"]
    with pytest.raises(FloatingPointError, match="^spectrum contains 3 non-finite values$"):
        checks.assert_all_finite(torch.from_numpy(bad), "spectrum")
    with pytest.raises(Exception, match="spectrum contains 3 non-finite values"):
        jchecks.assert_all_finite(jnp.asarray(bad), "spectrum").block_until_ready()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # a numpy array goes to the card
        checks.count_nonfinite(bad)


def test_metrics_and_log_event():
    snaps = []
    for mod in (metrics, jmetrics):
        m = mod.Metrics()
        m.count("frames", 3)
        m.count("frames")
        m.gauge("lag_s", 0.5)
        with m.timer("step"):
            pass
        snap = m.snapshot()
        snap.pop("step_seconds")
        snaps.append(snap)
        buf = io.StringIO()
        m.emit("bench", stream=buf, chip="H100")
        rec = json.loads(buf.getvalue())
        assert rec["event"] == "bench" and rec["frames"] == 4 and "ts" in rec
    assert snaps[0] == snaps[1] == {"frames": 4, "lag_s": 0.5, "step_calls": 1}
    lines = []
    for mod in (metrics, jmetrics):
        buf = io.StringIO()
        mod.log_event("e", stream=buf, a=1, b="x")
        rec = json.loads(buf.getvalue())
        rec.pop("ts")
        lines.append(rec)
    assert lines[0] == lines[1]


def test_throughput_meter(monkeypatch, tmp_path):
    ours, ref = metrics.ThroughputMeter(n_devices=4), jmetrics.ThroughputMeter(n_devices=4)
    for tm in (ours, ref):
        tm.update(1_000_000, 0.5)
        tm.update(3_000_000, 1.5)
    assert ours.snapshot() == ref.snapshot()
    assert ours.scaling_efficiency(0.4) == ref.scaling_efficiency(0.4)
    # n_devices=None: the process group's world size, else the CUDA devices;
    # a CPU is never counted
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="pass n_devices="):
        metrics.ThroughputMeter()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert metrics.ThroughputMeter().n_devices == 2
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert metrics.ThroughputMeter().n_devices == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("work,small,large", [(8e9, 0.010, 0.020), (1.0, 1e-6, 3e-6),
                                              (5e8, 0.5, 0.75), (8e9, 0.020, 0.010),
                                              (8e9, 0.010, 0.010)])
def test_slope_rate(work, small, large):
    got = profiling.slope_rate(work, small, large)
    if large > small:
        assert got == jprof.slope_rate(work, small, large)
    else:
        assert math.isnan(got)
        assert jprof.slope_rate(work, small, large) >= work / 1e-12  # the clamp


def test_device_hbm_bandwidth(monkeypatch):
    with pytest.raises(ValueError, match="cpu has no device-memory figure"):
        profiling.device_hbm_bandwidth("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.device_hbm_bandwidth()
    for name, want in (("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert profiling.device_hbm_bandwidth("cuda:0") == want
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100-SXM4-80GB"):
        profiling.device_hbm_bandwidth("cuda:0")


def test_benchmark_timed_median_and_hard_sync(monkeypatch):
    def no_sync(*_):
        raise AssertionError("a CPU result needs no CUDA sync")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    x = torch.ones(4096)
    profiling.hard_sync({"a": (x, [x * 2.0]), "b": 3})
    r = profiling.benchmark(lambda v: v * 2.0, x, iters=3, samples_per_call=4096)
    assert r.seconds_per_call > 0.0 and r.samples_per_second > 0.0 and r.hbm_fraction == 0.0
    assert str(r).startswith(f"{r.seconds_per_call * 1e3:.3f} ms/call")
    with pytest.raises(ValueError, match="cpu has no device-memory figure"):
        profiling.benchmark(lambda v: v * 2.0, x, iters=1, samples_per_call=4096,
                            min_bytes_per_sample=8.0)
    calls = []
    assert profiling.timed_median(lambda v: calls.append(1) or v * 2.0, x, steps=3, reps=3) > 0
    assert len(calls) == 1 + 3 * 3  # the warm-up, then steps x reps
    assert str(profiling.BenchResult(0.002, 5e8, 0.25)) == str(jprof.BenchResult(0.002, 5e8, 0.25))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        _ = torch.ones(1024) * 2.0
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mul" in str(e.get("name", "")) for e in events)
    assert prof.key_averages() is not None
