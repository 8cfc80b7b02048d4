"""The port's own spans (`utils.profiling.span`): with no profiler one shared
null context; under torch.profiler each entry point's `nx.*` spans appear
once a call, nested where the work happens, in the exported Chrome trace,
and the outputs equal the untraced ones bit for bit.

The file imports neither JAX nor the JAX package; its one `cuda` case runs
on a card with the others of that marker:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tracing.py
"""

import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nx_signal_tpu_torch.models.pipeline import StftFirChain, stft_fir_chain
from nx_signal_tpu_torch.ops.filters import firwin
from nx_signal_tpu_torch.ops.windows import hann
from nx_signal_tpu_torch.spectral.stft import istft, stft
from nx_signal_tpu_torch.utils import profiling

CALLS = 2
N_FFT, HOP = 256, 64


def _signal(device="cpu"):
    gen = torch.Generator().manual_seed(0)
    return torch.randn(3, 4096, generator=gen).to(device)


def _chain(device="cpu", precision="highest"):
    taps = firwin(31, [0.2], device="cpu").numpy()
    return StftFirChain.from_numpy(taps, hann(N_FFT, device="cpu").numpy(), stride=HOP,
                                   n_fft=N_FFT, precision=precision, device=device)


def _window():
    return hann(N_FFT, device="cpu")


def _run_chain():
    chain, x = _chain(), _signal()
    return lambda: chain(x)


def _run_stft():
    x, w = _signal(), _window()
    return lambda: stft(x, w, fft_length=N_FFT, overlap_length=N_FFT - HOP, onesided=True).z


def _run_istft():
    w = _window()
    z = stft(_signal(), w, fft_length=N_FFT, overlap_length=N_FFT - HOP, onesided=True).z
    return lambda: istft(z, w, fft_length=N_FFT, overlap_length=N_FFT - HOP, onesided=True,
                         method="matmul")


def _run_filtered():
    x, w = _signal(), _window()
    taps = firwin(31, [0.2], device="cpu")
    return lambda: stft_fir_chain(x, taps, w, fft_length=N_FFT, overlap_length=N_FFT - HOP,
                                  fir_method="direct", return_filtered=True)


# each case: its call, the nx.* spans one call makes, and (inner, outer)
# pairs where each inner span lies inside an outer one
CASES = {
    "chain": (_run_chain, {"nx.chain"}, []),
    "stft": (_run_stft, {"nx.stft"}, []),
    "istft": (_run_istft, {"nx.istft", "nx.weights.idft", "nx.idft.product"},
              [("nx.weights.idft", "nx.istft"), ("nx.idft.product", "nx.istft")]),
    "stft_fir_chain": (_run_filtered, {"nx.stft_fir_chain", "nx.fir"},
                       [("nx.fir", "nx.stft_fir_chain")]),
}


def _spans(path):
    """{name: sorted [(start, end)]} of the trace's nx.* user annotations."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("nx."):
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {name: sorted(v) for name, v in spans.items()}


def _traced(fn, path, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        outs = [fn() for _ in range(CALLS)]
    prof.export_chrome_trace(str(path))
    return outs


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("name", ["nx.chain", "nx.weights.a_tc", "nx.idft.product"])
def test_span_without_a_profiler_is_the_shared_null_context(name, monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda n: made.append(n))
    assert not torch.autograd._profiler_enabled()
    first = profiling.span(name)
    assert first is profiling.span("nx.other")
    with first:
        pass
    assert made == []


@pytest.mark.parametrize("case", list(CASES))
def test_each_span_appears_once_a_call_where_the_work_is(case, tmp_path):
    make, names, nested = CASES[case]
    path = tmp_path / "trace.json"
    _traced(make(), path)
    spans = _spans(path)
    assert Counter({n: len(v) for n, v in spans.items()}) == Counter(
        {n: CALLS for n in names})
    for inner, outer in nested:
        for span in spans[inner]:
            assert any(_inside(span, o) for o in spans[outer]), (inner, outer)
    if case == "istft":
        # the weights first, then the product, inside each call's istft
        for weights, product in zip(spans["nx.weights.idft"], spans["nx.idft.product"]):
            assert weights[1] <= product[0]


@pytest.mark.parametrize("case", list(CASES))
def test_traced_outputs_equal_untraced_bitwise(case, tmp_path):
    fn = CASES[case][0]()
    plain = fn()
    traced = _traced(fn, tmp_path / "trace.json")
    for out in traced:
        pairs = zip(plain, out) if isinstance(plain, tuple) else [(plain, out)]
        for want, got in pairs:
            assert torch.equal(want, got)


@pytest.mark.cuda
def test_tc_weights_span_sits_inside_the_chain_and_before_the_launch_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    chain, x = _chain("cuda", precision="high"), _signal("cuda")
    chain(x)   # builds the library
    torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    _traced(lambda: chain(x), path, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    torch.cuda.synchronize()
    spans = _spans(path)
    assert len(spans["nx.chain"]) == CALLS and len(spans["nx.weights.a_tc"]) == CALLS
    for w in spans["nx.weights.a_tc"]:
        assert any(_inside(w, c) for c in spans["nx.chain"])
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "framed_dft_tc_kernel" in e["name"]]
    assert len(kernels) == CALLS
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    for k in kernels:
        at = launches[k["args"]["correlation"]]
        assert any(c[0] <= at <= c[1] for c in spans["nx.chain"])
        assert not any(w[0] <= at <= w[1] for w in spans["nx.weights.a_tc"])
