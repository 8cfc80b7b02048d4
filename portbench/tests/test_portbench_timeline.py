"""The trace reader on a small hand-made Chrome trace: two calls, each a
launch, a copy to the host inside `.item()`, and a kernel whose launch the
trace lost (a library with its own CUDA runtime)."""

import json

import pytest

from portbench.core.timeline import Timeline


def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid,
            "args": args}


def _call(t0, corr):
    """A call span of 100 us at t0: a launch (kernel 20 us), then `.item()`
    (40 us, its copy to the host inside), then a kernel with no launch."""
    return [
        _x("user_annotation", "call", t0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 5, 5, correlation=corr),
        _x("cpu_op", "aten::item", t0 + 20, 45),
        _x("cpu_op", "aten::_local_scalar_dense", t0 + 21, 40),
        _x("cuda_runtime", "cudaMemcpyAsync", t0 + 22, 30, correlation=corr + 1),
        _x("cuda_runtime", "cudaStreamSynchronize", t0 + 53, 6),
        _x("kernel", "tc_kernel", t0 + 12, 20, tid=7, pid=0, correlation=corr),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", t0 + 50, 2, tid=7, pid=0,
           correlation=corr + 1),
        _x("kernel", "orphan_kernel", t0 + 70, 10, tid=7, pid=0, correlation=999_000 + corr),
    ]


@pytest.fixture
def timeline(tmp_path):
    path = tmp_path / "t.json"
    events = _call(1000, 10) + _call(1200, 20)
    events.append(_x("cuda_runtime", "cudaEventSynchronize", 1150, 40))  # the harness's own
    path.write_text(json.dumps({"traceEvents": events}))
    return Timeline(path)


def test_window_busy_and_idle(timeline):
    # from the first device op (1012, after the first call's start) to the
    # last call's end (1300); busy 2 x 32 us
    assert timeline.window_s == pytest.approx(288e-6)
    assert timeline.busy_s == pytest.approx(64e-6)
    assert timeline.idle_pct() == pytest.approx(100 * (1 - 64 / 288))


def test_host_issue_leaves_out_the_waits(timeline):
    # the item's copy and stream sync are one held wait of 40 us
    assert timeline.syncs_per_call() == 1.0
    assert timeline.host_issue_ms() == pytest.approx(60e-3)


def test_an_operation_with_no_launch_joins_the_span_of_the_next(timeline):
    assert timeline.orphans == 2
    # call 1: tc 20 + copy 2; call 2: the same, call 1's orphan (the next
    # launched op on its stream is call 2's) and its own (none follows: the
    # launch before it)
    assert timeline.device_ms("call") == pytest.approx((22 + 42) / 2 * 1e-3)
    assert timeline.device_ms("call", names=("tc_kernel",)) == pytest.approx(20e-3)
    assert timeline.device_ms("stft") is None


def test_breakdown_names_ops_and_gaps(timeline):
    parts = timeline.breakdown()
    assert parts["device_ops"][0] == ["tc_kernel", pytest.approx(40e-6)]
    names = [n for n, _ in parts["idle_gaps"]]
    assert "aten::_local_scalar_dense" in names or "cudaMemcpyAsync" in names
