"""The readers of the program's own spans (core/spans.py and the metrics
weights_ms, weights_idle_pct, weight_builds_per_call, idft_product_ms,
fir_ms) on a small hand-made Chrome trace, each against a count by hand;
and, in whole CPU runs of each one-card cell, the new metrics by name in
the last line of a traced run."""

import json
from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench.core.spec import Bench
from portbench.core.timeline import Timeline
from test_portbench_runs import ONE_CHIP, SPEC, cpu, small  # noqa: F401  (small: a fixture)

NEW = ("weights_ms", "weights_idle_pct", "weight_builds_per_call", "idft_product_ms", "fir_ms")


def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid,
            "args": args}


def _span(name, lo, hi):
    return _x("user_annotation", name, lo, hi - lo)


def _launch(ts, corr, kernel, lo, hi):
    """A launch at host time ts and its kernel on the device over [lo, hi)."""
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 2, correlation=corr),
            _x("kernel", kernel, lo, hi - lo, tid=7, pid=0, correlation=corr)]


def _trace():
    """Two calls of 100 us, [1000, 1100) and [1100, 1200). In each: a
    weights span holding a sync (the first also a nested weights span),
    then the product and the FIR, each launching one kernel. A kernel
    launched before the window keeps the card busy over [1000, 1020).

    Busy: [1000, 1020) + [1060, 1095) + [1145, 1190) = 100 of 200 us."""
    return [
        *_launch(990, 1, "prev", 1000, 1020),
        _span("call", 1000, 1100),
        _span("nx.chain", 1001, 1099),
        _span("nx.weights.a_tc", 1010, 1050),
        _x("cpu_op", "aten::_local_scalar_dense", 1012, 10),
        _span("nx.weights.fold", 1030, 1040),
        _span("nx.idft.product", 1055, 1065),
        *_launch(1056, 2, "sgemm", 1060, 1080),
        _span("nx.fir", 1070, 1090),
        *_launch(1071, 3, "conv", 1080, 1095),
        _span("call", 1100, 1200),
        _span("nx.chain", 1101, 1199),
        _span("nx.weights.a_tc", 1105, 1135),
        _x("cuda_runtime", "cudaStreamSynchronize", 1120, 5),
        _span("nx.idft.product", 1140, 1150),
        *_launch(1141, 4, "sgemm", 1145, 1175),
        _span("nx.fir", 1160, 1170),
        *_launch(1161, 5, "conv", 1175, 1190),
    ]


def _read(events, tmp_path, name):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Bench(ROOT).reader(name).read(SimpleNamespace(timeline=Timeline(path)))


# by hand, per call: the weights' host time less its sync (40 - 10, 30 - 5);
# their overlap with the idle card ([1020, 1050) and [1105, 1135), of a
# 200 us window); two outermost weights spans in two calls; the product's
# kernels (20, 30) and the FIR's (15, 15)
HAND = {"weights_ms": (30 + 25) / 2 * 1e-3, "weights_idle_pct": 100 * (30 + 30) / 200,
        "weight_builds_per_call": 1.0, "idft_product_ms": (20 + 30) / 2 * 1e-3,
        "fir_ms": 15e-3}


@pytest.mark.parametrize("name", NEW)
def test_reader_matches_a_count_by_hand(name, tmp_path):
    assert _read(_trace(), tmp_path, name) == pytest.approx(HAND[name])


def test_the_weights_idle_share_is_at_most_the_idle_share(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    assert _read(_trace(), tmp_path, "weights_idle_pct") <= Timeline(path).idle_pct() == 50.0


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_none(name, tmp_path):
    events = [e for e in _trace() if not e["name"].startswith("nx.")]
    assert _read(events, tmp_path, name) is None


@pytest.mark.parametrize("name", ["weights_ms", "weights_idle_pct", "weight_builds_per_call"])
def test_a_program_that_keeps_its_weights_reads_zero(name, tmp_path):
    events = [e for e in _trace() if not e["name"].startswith("nx.weights.")]
    assert _read(events, tmp_path, name) == 0.0


@pytest.mark.parametrize("name", ["idft_product_ms", "fir_ms"])
def test_a_span_that_launched_nothing_reads_zero(name, tmp_path):
    events = [e for e in _trace() if e["cat"] not in ("kernel", "cuda_runtime")]
    assert _read(events, tmp_path, name) == 0.0


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_traced_cpu_run_prints_the_new_metrics(small, cell):  # noqa: F811
    line, _ = cpu(small, cell, "--trace", "1")
    listed = {m["name"] for m in SPEC["per_layer"]
              if m["name"].split(".")[0] in NEW and cell in m["workloads"]}
    assert listed and listed <= set(line["metrics"])
    if "weight_builds_per_call.roundtrip" in listed:
        # the plain istft rebuilds its inverse-DFT weights once a call
        assert line["metrics"]["weight_builds_per_call.roundtrip"]["value"] == 1.0
