"""Parity of the port's waveforms (nx_signal_tpu_torch/ops/waveforms.py)
with the JAX package's (nx_signal_tpu/ops/waveforms.py), on the CPU, with
the same numpy inputs made from a seed.

Both packages compute in the signal's dtype in the same order, so the
elementwise waveforms agree to a few float32 ulps of their argument: 1e-5
where the argument stays below ~10 rad, 1e-4 for chirps whose phase
reaches a few hundred rad (an ulp of 300 is 3e-5; the logarithmic and
hyperbolic chirps take a float32 pow / log, whose last bit differs between
libraries). square is held bitwise. The float32 chirp drifts from a
float64 chirp as the JAX package's does (`test_chirp_f32_phase_drift`, a
pin in ROADMAP.md queue 3).
"""

import math

import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import waveforms as jw
from nx_signal_tpu_torch.ops import waveforms as tw

_RNG = np.random.default_rng(0)
T32 = np.sort(_RNG.uniform(-20.0, 20.0, size=1001)).astype(np.float32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", [0.0, 0.25, 0.5, 0.77, 1.0])
def test_sawtooth_matches_jax(width, dtype):
    t = T32.astype(dtype)
    got = tw.sawtooth(T(t), width=width)
    assert got.dtype == torch.from_numpy(t).dtype
    close(got, jw.sawtooth(t, width=width), 1e-5)


@pytest.mark.parametrize("duty", [0.1, 0.5, 1.0, 0.3])
def test_square_matches_jax_bitwise(duty):
    got = tw.square(T(T32), duty=duty)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw.square(T32, duty=duty)))


def test_square_time_varying_duty_and_integer_time():
    t = np.arange(10) * (2 * np.pi / 10)
    duty = np.array([0.1, 0, 0.3, 0, 0.5, 0, 0.7, 0, 0.9, 0])
    np.testing.assert_array_equal(tw.square(T(t), duty=duty).numpy(),
                                  np.asarray(jw.square(t, duty=duty)))
    ints = np.arange(-7, 9)
    got = tw.square(T(ints))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw.square(ints)))
    assert tw.sawtooth(T(ints)).dtype == torch.float32


def test_gaussian_pulse_and_gausspulse_match_jax():
    t = np.linspace(-1e-3, 1e-3, 201).astype(np.float32)
    got = tw.gaussian_pulse(T(t), center_frequency=3000.0, bandwidth=0.7,
                            bandwidth_reference_level=-3.0)
    want = jw.gaussian_pulse(t, center_frequency=3000.0, bandwidth=0.7,
                             bandwidth_reference_level=-3.0)
    assert isinstance(got, tw.GaussianPulse)
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    for retquad, retenv in [(False, False), (True, False), (False, True), (True, True)]:
        g = tw.gausspulse(T(t), fc=2000.0, retquad=retquad, retenv=retenv)
        w = jw.gausspulse(t, fc=2000.0, retquad=retquad, retenv=retenv)
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            close(a, b, 1e-5)
    assert tw.gausspulse("cutoff", fc=2000.0, tpr=-40.0) == pytest.approx(
        jw.gausspulse("cutoff", fc=2000.0, tpr=-40.0), rel=1e-15)


def test_waveform_errors_match_jax():
    t = T(T32)
    for fn, kwargs, match in [
            (tw.sawtooth, dict(width=1.5), "width must be between 0 and 1"),
            (tw.gaussian_pulse, dict(center_frequency=-1), "Center frequency"),
            (tw.gaussian_pulse, dict(bandwidth=0), "Bandwidth must be"),
            (tw.gaussian_pulse, dict(bandwidth_reference_level=1), "Bandwidth reference level")]:
        with pytest.raises(ValueError, match=match):
            fn(t, **kwargs)
    with pytest.raises(ValueError, match="invalid method"):
        tw.chirp(t, 1.0, 1.0, 2.0, method="cubic")
    with pytest.raises(ValueError, match="must be 'cutoff'"):
        tw.gausspulse("start")
    with pytest.raises(ValueError, match="phi_unit"):
        tw.polynomial_sweep(t, [1.0], phi_unit="turns")


@pytest.mark.parametrize("method,kwargs,f0,f1", [
    ("linear", {}, 1.0, 5.0), ("quadratic", {}, 1.0, 5.0),
    ("quadratic", {"vertex_zero": False}, 1.0, 5.0), ("logarithmic", {}, 1.0, 5.0),
    ("logarithmic", {}, 2.0, 2.0), ("hyperbolic", {}, 1.0, 5.0), ("hyperbolic", {}, 3.0, 3.0),
    ("linear", {"phi": 0.7}, 5.0, 0.5)])
def test_chirp_every_method_matches_jax(method, kwargs, f0, f1):
    t = np.linspace(0.0, 10.0, 2001).astype(np.float32)
    got = tw.chirp(T(t), f0, 10.0, f1, method=method, **kwargs)
    assert got.dtype == torch.float32
    close(got, jw.chirp(t, f0, 10.0, f1, method=method, **kwargs), 1e-4)
    t64 = t.astype(np.float64)
    close(tw.chirp(T(t64), f0, 10.0, f1, method=method, **kwargs),
          jw.chirp(t64, f0, 10.0, f1, method=method, **kwargs), 1e-9)


def test_chirp_logarithmic_without_a_sign_is_nan():
    got = tw.chirp(T(T32), -1.0, 10.0, 1.0, method="logarithmic")
    assert bool(torch.isnan(got).all()) and got.shape == (T32.shape[0],)


@pytest.mark.parametrize("n,drift", [(48_000, 3.3e-3), (480_000, 0.0412)])
def test_chirp_f32_phase_drift(n, drift):
    """A linear chirp 100 Hz -> 8 kHz at 48 kHz: the port's float32 phase
    is the JAX package's to 1e-6, and both drift from scipy's float64 chirp
    by the same amount (3.3e-3 at 1 s, 0.041 at 10 s)."""
    t = (np.arange(n) / 48000.0).astype(np.float32)
    got = tw.chirp(T(t), 100.0, n / 48000.0, 8000.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jw.chirp(t, 100.0, n / 48000.0, 8000.0)),
                               rtol=0, atol=1e-6)
    f64 = sps.chirp(t.astype(np.float64), 100.0, n / 48000.0, 8000.0)
    assert float(np.abs(got - f64).max()) == pytest.approx(drift, rel=0.05)


@pytest.mark.parametrize("coefs,phi,unit", [
    ([2.0, 1.0], 0.0, "radians"), ([0.1, -0.5, 2.0, 1.0], 0.3, "radians"),
    ([1.0, 0.0, 3.0], 45.0, "degrees")])
def test_polynomial_sweep_and_sweep_poly_match_jax(coefs, phi, unit):
    t = np.linspace(0.0, 3.0, 301).astype(np.float32)
    close(tw.polynomial_sweep(T(t), coefs, phi=phi, phi_unit=unit),
          jw.polynomial_sweep(t, coefs, phi=phi, phi_unit=unit), 1e-5)
    if unit == "degrees":
        close(tw.sweep_poly(T(t), np.poly1d(coefs), phi),
              jw.sweep_poly(t, np.poly1d(coefs), phi), 1e-5)


@pytest.mark.parametrize("shape,index", [(5, 2), ((3, 4), (1, 2)), ((3, 4), "midpoint"),
                                         ((4, 3), np.array([3, 0])), (6, -1), (4, 9)])
def test_unit_impulse_matches_jax(shape, index):
    got = tw.unit_impulse(shape, index=index, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw.unit_impulse(shape, index=index)))
    assert tw.unit_impulse(shape, index=index, dtype=torch.float64,
                           device="cpu").dtype == torch.float64
    with pytest.raises(ValueError, match="midpoint"):
        tw.unit_impulse(shape, index="middle")


def test_sinc_matches_jax_and_promotes_integers():
    t = np.concatenate([T32, [0.0]]).astype(np.float32)
    close(tw.sinc(T(t)), jw.sinc(t), 1e-6)
    ints = np.arange(-3, 4)
    got = tw.sinc(T(ints))
    assert got.dtype == torch.float32
    close(got, jw.sinc(ints), 1e-6)
    assert float(tw.sinc(torch.tensor(0.0))) == 1.0
    assert math.isfinite(float(tw.sinc(torch.tensor(1e-30))))
