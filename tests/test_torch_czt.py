"""Parity of the port's chirp-Z transform and zoom FFT
(nx_signal_tpu_torch/ops/czt.py) with the JAX package's, on the CPU, with
the same numpy inputs made from a seed, at the JAX tests' gate 1e-5 (both
packages return complex64). Both routes are held, the matmul one and
Bluestein's, on both sides of the port's cut `_MAX_MATMUL_NM` (and with
the JAX package forced onto the same route).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import nx_signal_tpu.ops.czt as jczt
import nx_signal_tpu_torch.ops.czt as tczt

_RNG = np.random.default_rng(0)
XC = _RNG.normal(size=(2, 100)) + 1j * _RNG.normal(size=(2, 100))
XR = _RNG.normal(size=(3, 128)).astype(np.float32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want):
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.fixture(params=["matmul", "bluestein"])
def route(request, monkeypatch):
    """Both packages on one route: the cut at 2^40 (every case a matmul)
    or at 1 (every case Bluestein)."""
    cut = 1 << 40 if request.param == "matmul" else 1
    monkeypatch.setattr(tczt, "_MAX_MATMUL_NM", cut)
    monkeypatch.setattr(jczt, "_MAX_MATMUL_NM", cut)
    return request.param


@pytest.mark.parametrize("x,m,w,a", [
    (XC, None, None, 1.0),
    (XC, 57, np.exp(-2j * np.pi / 57), np.exp(0.1j)),
    (XR, 64, np.exp(-2j * np.pi * 0.3 / 64), np.exp(2j * np.pi * 0.05)),
], ids=["dft", "unit-circle", "real-arc"])
def test_czt_matches_jax_on_both_routes(route, x, m, w, a):
    plan = tczt._CztPlan(x.shape[-1], m, w, a)
    assert plan._matmul == (route == "matmul")
    close(tczt.czt(T(x), m, w, a), jczt.czt(x, m, w, a))


def test_czt_off_the_unit_circle_matches_jax_on_the_matmul_route():
    """|w| != 1: Bluestein's chirps cancel catastrophically in both
    packages (and in scipy); the matmul route holds the JAX package's."""
    x, w, a = XC[:, :40], np.exp(-0.01 - 2j * np.pi / 37), 0.98 * np.exp(0.3j)
    assert tczt._CztPlan(40, 37, w, a)._matmul
    close(tczt.czt(T(x), 37, w, a), jczt.czt(x, 37, w, a))


def test_the_cut_picks_the_route():
    """n*m at the cut takes the matmul, one past it Bluestein."""
    cut = tczt._MAX_MATMUL_NM
    assert tczt._CztPlan(1024, cut // 1024)._matmul
    assert not tczt._CztPlan(1024, cut // 1024 + 1)._matmul
    for n, m in [(1024, cut // 1024), (1024, cut // 1024 + 1)]:
        x = _RNG.normal(size=(1, n)).astype(np.float32)
        np.testing.assert_allclose(tczt.czt(T(x), m).numpy(), sps.czt(x, m),
                                   atol=1e-5 * np.sqrt(n), rtol=1e-5)


def test_czt_axis_and_errors():
    x = _RNG.normal(size=(50, 3))
    close(tczt.czt(T(x), 20, axis=0), jczt.czt(x, 20, axis=0))
    with pytest.raises(ValueError, match="positive"):
        tczt.czt(T(np.zeros(8)), 0)
    with pytest.raises(ValueError, match="defined for length 8"):
        tczt.CZT(8)(T(np.zeros(9)))


@pytest.mark.parametrize("fn,m,fs,endpoint", [
    ([0.1, 0.4], 128, 2.0, False), (0.5, 64, 2.0, False), ([0.2, 0.3], 33, 2.0, True),
    ([1000.0, 2000.0], 50, 48000.0, False)])
def test_zoom_fft_and_classes_match_jax(fn, m, fs, endpoint):
    x = _RNG.normal(size=(2, 256))
    close(tczt.zoom_fft(T(x), fn, m, fs=fs, endpoint=endpoint),
          jczt.zoom_fft(x, fn, m, fs=fs, endpoint=endpoint))
    plan, jplan = (mod.ZoomFFT(256, fn, m, fs=fs, endpoint=endpoint) for mod in (tczt, jczt))
    close(plan(T(x)), jplan(x))
    assert (plan.n, plan.m, plan.f1, plan.f2, plan.fs) == (jplan.n, jplan.m, jplan.f1, jplan.f2,
                                                           jplan.fs)
    assert plan.w == jplan.w and plan.a == jplan.a
    close(plan.points(device="cpu"), jplan.points())


def test_czt_class_keeps_its_device_copies():
    plan = tczt.CZT(100, 57, np.exp(-2j * np.pi / 57), np.exp(0.1j))
    close(plan(T(XC)), jczt.CZT(100, 57, np.exp(-2j * np.pi / 57), np.exp(0.1j))(XC))
    first = plan._plan._copies[torch.device("cpu")]
    plan(T(XC))
    assert plan._plan._copies[torch.device("cpu")] is first


@pytest.mark.parametrize("m,w,a", [(3, None, 1.0), (16, np.exp(-0.02j), 0.9 + 0.1j)])
def test_czt_points_match_jax(m, w, a):
    got = tczt.czt_points(m, w, a, device="cpu")
    assert got.device.type == "cpu"
    close(got, jczt.czt_points(m, w, a))
    with pytest.raises(ValueError, match="positive"):
        tczt.czt_points(0)


def test_zoom_fft_errors_match_jax():
    with pytest.raises(ValueError, match="fs/2"):
        tczt.zoom_fft(T(np.zeros(64)), [0.5, 1.5], 32, fs=2.0)
    with pytest.raises(ValueError, match="pair"):
        tczt.zoom_fft(T(np.zeros(64)), [0.1, 0.2, 0.3], 32)
