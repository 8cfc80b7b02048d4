"""Parity of the port's IIR design math (nx_signal_tpu_torch/ops/iir_design.py
and ops/ltisys.py:normalize) with the JAX package's, on the CPU.

Both are host f64 numpy and return numpy arrays. Tolerances: the gates of
tests/test_iir.py and tests/test_iir_order.py, the tightest of them for
every name: 1e-12 absolute and relative on every array and scalar (the
prototypes' 1e-12, the conversions' 1e-12; the same numpy operations run
in the same order, so they agree far closer); orders and integer outputs
exactly; the error messages the same.
"""

import warnings

import numpy as np
import pytest

from nx_signal_tpu.ops import iir_design as jd
from nx_signal_tpu.ops import ltisys as jl
from nx_signal_tpu_torch.ops import iir_design as td
from nx_signal_tpu_torch.ops import ltisys as tl

SOS = [[1.0, 0.0, -1.0, 1.0, 0.0, 0.25], [0.5, 0.2, 0.1, 1.0, -0.4, 0.3]]
Z, P, K = [0.5j, -0.5j, 1.0], [0.3 + 0.4j, 0.3 - 0.4j, -0.2], 2.0
BA = ([1.0, 0.5, 0.25], [1.0, -0.3, 0.2, 0.05])

CALLS = [
    ("buttap", (5,), {}),
    ("cheb1ap", (4, 1.0), {}),
    ("cheb2ap", (5, 40.0), {}),
    ("ellipap", (6, 0.5, 60.0), {}),
    ("ellipap", (1, 1.0, 40.0), {}),
    ("besselap", (7,), {}),
    ("besselap", (4,), dict(norm="delay")),
    ("lp2lp_zpk", (Z, P, K), dict(wo=2.0)),
    ("lp2hp_zpk", (Z, P, K), dict(wo=2.0)),
    ("lp2bp_zpk", (Z, P, K), dict(wo=1.5, bw=0.5)),
    ("lp2bs_zpk", (Z, P, K), dict(wo=1.5, bw=0.5)),
    ("bilinear_zpk", (Z, [-1.0 + 0.5j, -1.0 - 0.5j, -2.0], K), dict(fs=10.0)),
    ("lp2lp", ([1.0], [1.0, 1.4, 1.0]), dict(wo=3.0)),
    ("lp2hp", ([1.0], [1.0, 1.4, 1.0]), dict(wo=3.0)),
    ("lp2bp", ([1.0], [1.0, 1.4, 1.0]), dict(wo=3.0, bw=0.5)),
    ("lp2bs", ([1.0], [1.0, 1.4, 1.0]), dict(wo=3.0, bw=0.5)),
    ("zpk2tf", (Z, P, K), {}),
    ("tf2zpk", BA, {}),
    ("zpk2sos", (Z, P, K), {}),
    ("tf2sos", BA, {}),
    ("sos2tf", (SOS,), {}),
    ("sos2zpk", (SOS,), {}),
    ("iirfilter", (4, [0.2, 0.5]), dict(rp=1.0, rs=40.0, btype="bandstop", ftype="ellip")),
    ("iirfilter", (3, 100.0), dict(btype="highpass", fs=1000.0, output="zpk")),
    ("iirfilter", (4, 2.0), dict(analog=True, ftype="cheby1", rp=1.0)),
    ("butter", (8, 0.3), dict(output="sos")),
    ("butter", (4, [0.1, 0.4]), dict(btype="bandpass")),
    ("cheby1", (6, 1.0, 0.3), {}),
    ("cheby2", (5, 40.0, [0.2, 0.6]), dict(btype="stop", output="sos")),
    ("ellip", (8, 0.5, 60.0, 0.15), dict(output="sos")),
    ("ellip", (8, 0.5, 60.0, 0.15), {}),
    ("bessel", (5, 0.25), dict(output="zpk")),
    ("iirnotch", (0.25, 30.0), {}),
    ("iirnotch", (60.0, 20.0), dict(fs=1000.0)),
    ("iirpeak", (0.25, 30.0), {}),
    ("iircomb", (0.25, 30.0), {}),
    ("iircomb", (100.0, 10.0), dict(ftype="peak", fs=1000.0, pass_zero=True)),
    ("buttord", (0.2, 0.3, 3.0, 40.0), {}),
    ("buttord", ([0.2, 0.5], [0.1, 0.6], 1.0, 40.0), {}),
    ("buttord", ([0.1, 0.6], [0.2, 0.5], 1.0, 40.0), {}),
    ("cheb1ord", (0.2, 0.3, 3.0, 40.0), {}),
    ("cheb1ord", ([0.1, 0.6], [0.2, 0.5], 1.0, 40.0), {}),
    ("cheb2ord", (0.3, 0.2, 3.0, 40.0), {}),
    ("cheb2ord", ([0.2, 0.5], [0.1, 0.6], 1.0, 40.0), {}),
    ("ellipord", (0.2, 0.3, 3.0, 40.0), {}),
    ("ellipord", (200.0, 300.0, 1.0, 60.0), dict(fs=2000.0)),
    ("ellipord", (1.0, 2.0, 1.0, 40.0), dict(analog=True)),
    ("iirdesign", (0.2, 0.3, 1.0, 40.0), dict(output="sos")),
    ("iirdesign", ([0.2, 0.5], [0.1, 0.6], 1.0, 40.0), dict(ftype="cheby2")),
    ("iirdesign", ([0.1, 0.6], [0.2, 0.5], 1.0, 40.0), dict(ftype="butter", output="zpk")),
    ("band_stop_obj", (0.25, 0, np.array([0.2, 0.7]), np.array([0.35, 0.5]), 3.0, 40.0,
                       "butter"), {}),
    ("band_stop_obj", (0.65, 1, np.array([0.2, 0.7]), np.array([0.35, 0.5]), 3.0, 40.0,
                       "ellip"), {}),
]


def assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    if isinstance(want, (int, np.integer)) and not isinstance(want, bool):
        assert got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert type(got.dtype) is type(want.dtype) or got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)


def test_every_name_is_ported():
    assert sorted(td.__all__) == sorted(jd.__all__)
    for name in jd.__all__ + ["band_stop_obj"]:
        assert callable(getattr(td, name))


@pytest.mark.parametrize("name,args,kw", CALLS, ids=[f"{c[0]}-{i}" for i, c in enumerate(CALLS)])
def test_design_matches_jax(name, args, kw):
    got = getattr(td, name)(*args, **kw)
    want = getattr(jd, name)(*args, **kw)
    assert_same(got, want)
    assert isinstance(got, (tuple, float, int, np.ndarray))


def test_every_name_is_called():
    called = {c[0] for c in CALLS}
    assert called == set(jd.__all__) | {"band_stop_obj"}


@pytest.mark.parametrize("call", [
    lambda m: m.butter(0, 0.3),
    lambda m: m.butter(2, 1.2),
    lambda m: m.butter(2, [0.3, 0.2], btype="bandpass"),
    lambda m: m.butter(2, 0.3, btype="comb"),
    lambda m: m.iirfilter(2, 0.3, ftype="nope"),
    lambda m: m.cheby1(2, None, 0.3),
    lambda m: m.ellipap(3, 2.0, 1.0),
    lambda m: m.butter(2, 0.3, output="xyz"),
    lambda m: m.iirfilter(2, 0.3, analog=True, fs=10.0),
    lambda m: m.buttord(0.2, [0.3, 0.4], 3.0, 40.0),
    lambda m: m.buttord([0.2, 0.5], [0.3, 0.6], 3.0, 40.0),
    lambda m: m.iirdesign(0.2, 0.3, 1.0, 40.0, ftype="bessel"),
    lambda m: m.iircomb(0.3, 30.0),
    lambda m: m.iircomb(0.25, 30.0, ftype="band"),
    lambda m: m.iirnotch(1.5, 30.0),
    lambda m: m.zpk2sos([1.0, 2.0, 3.0], [0.5], 1.0),
    lambda m: m.sos2zpk(np.zeros((2, 5))),
    lambda m: m.band_stop_obj(0.25, 0, [0.2, 0.7], [0.35, 0.5], 3.0, 40.0, "bessel"),
    lambda m: m.lp2lp_zpk([1.0, 2.0], [0.5], 1.0),
])
def test_errors_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jd)
    with pytest.raises(ValueError) as got:
        call(td)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("b,a", [([2.0, 4.0], [2.0, 1.0]),
                                 ([[1.0, 2.0, 3.0], [0.0, 1.0, 4.0]], [2.0, 1.0, 0.5]),
                                 ([0.0, 0.0, 3.0, 6.0], [2.0, 4.0]),
                                 ([1e-10, 1.0], [1.0, 1.0])])
def test_normalize_matches_jax(b, a):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = tl.normalize(b, a)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jl.normalize(b, a)
    assert_same(got, want)
    assert [w.category.__name__ for w in got_w] == [w.category.__name__ for w in want_w]
    assert all(issubclass(w.category, tl.BadCoefficients) for w in got_w)


@pytest.mark.parametrize("b,a", [([1.0], [[1.0, 2.0]]), ([1.0], [0.0, 0.0]),
                                 ([1.0, 2.0, 3.0], [1.0, 2.0]),
                                 (np.ones((2, 2, 2)), [1.0])])
def test_normalize_errors_match_jax(b, a):
    with pytest.raises(ValueError) as want:
        jl.normalize(b, a)
    with pytest.raises(ValueError) as got:
        tl.normalize(b, a)
    assert str(got.value) == str(want.value)
