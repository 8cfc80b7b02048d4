"""Parity of the port's spectral estimation (nx_signal_tpu_torch/spectral/
estimation.py) with the JAX package's, on the CPU, with the same numpy
inputs.

Tolerances: the Welch family (welch, csd, periodogram, coherence) within
1e-4 of the max, the JAX package's gate for f32 spectra (f32 FFTs and
contractions summed in another order), across every detrend, scaling and
average (even and odd segment counts for 'median'), one- and two-sided,
real and complex input; frequencies at rtol 1e-6. lombscargle and
vectorstrength on f64 inputs at the JAX package's own 1e-9 of the max
(tests/test_savgol_lomb_conv2d.py) and 1e-10.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu_torch.spectral import estimation as te

je = importlib.import_module("nx_signal_tpu.spectral.estimation")


def close_to_max(got, want, rel=1e-4):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def signals(rng, shape=(2, 4000), complex_input=False):
    x = rng.normal(size=shape) + np.sin(0.3 * np.arange(shape[-1])) * 3.0 + 0.5
    y = np.roll(x, 3, axis=-1) * 0.7 + rng.normal(size=shape) * 0.3
    if complex_input:
        x = x + 1j * rng.normal(size=shape)
        y = y + 1j * rng.normal(size=shape)
        return x.astype(np.complex64), y.astype(np.complex64)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("detrend", ["constant", "linear", False, None])
@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("average,overlap", [("mean", None), ("median", None),
                                             ("median", 56)])
@pytest.mark.parametrize("onesided", [True, False])
def test_welch_matches_jax(detrend, scaling, average, overlap, onesided, rng):
    """'median' at overlap 128 (30 segments, even) and 56 (odd: 19)."""
    x, _ = signals(rng)
    kw = dict(sampling_rate=1000.0, segment_length=256, overlap_length=overlap,
              detrend=detrend, scaling=scaling, average=average, onesided=onesided)
    f, p = je.welch(jnp.asarray(x), **kw)
    gf, gp = te.welch(torch.from_numpy(x), **kw)
    assert gp.dtype == torch.float32
    close_to_max(gp, p)
    np.testing.assert_allclose(gf.numpy(), np.asarray(f), rtol=1e-6)


@pytest.mark.parametrize("average", ["mean", "median"])
@pytest.mark.parametrize("detrend", ["constant", "linear"])
@pytest.mark.parametrize("complex_input", [False, True])
def test_csd_matches_jax(average, detrend, complex_input, rng):
    x, y = signals(rng, complex_input=complex_input)
    kw = dict(sampling_rate=2.0, segment_length=200, overlap_length=120, fft_length=256,
              detrend=detrend, average=average, onesided=not complex_input,
              window=("kaiser", 5.0))
    _, p = je.csd(jnp.asarray(x), jnp.asarray(y), **kw)
    _, gp = te.csd(torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert gp.dtype == torch.complex64
    close_to_max(gp, p)


@pytest.mark.parametrize("segments", [30, 31])
def test_median_of_an_even_segment_count_matches_jax(segments, rng):
    """An even count takes the mean of the two middle segments (numpy's and
    jnp's median); torch.median's lower middle value would miss."""
    x = rng.normal(size=(3, 128 * (segments + 1))).astype(np.float32)
    kw = dict(segment_length=256, overlap_length=128, average="median")
    _, p = je.welch(jnp.asarray(x), **kw)
    _, gp = te.welch(torch.from_numpy(x), **kw)
    close_to_max(gp, p)
    z = te._segment_spectra(torch.from_numpy(x), te._resolve_window("hann", 256, "cpu"),
                            stride=128, n_fft=256, onesided=True, detrend="constant",
                            precision="highest")
    assert z.shape[-2] == segments
    if segments % 2 == 0:   # torch.median would differ from the reference here
        power = z.real ** 2 + z.imag ** 2
        lower = torch.median(power, dim=-2).values
        assert not np.allclose(lower.numpy(), te._median_last(power.transpose(-1, -2)).numpy())


def test_periodogram_and_coherence_match_jax(rng):
    x, y = signals(rng, shape=(3, 2048))
    for kw in (dict(), dict(window="hann", detrend="linear", scaling="spectrum"),
               dict(fft_length=3000, onesided=False, detrend=False)):
        _, p = je.periodogram(jnp.asarray(x), sampling_rate=100.0, **kw)
        _, gp = te.periodogram(torch.from_numpy(x), sampling_rate=100.0, **kw)
        close_to_max(gp, p)
    for kw in (dict(segment_length=128), dict(segment_length=256, overlap_length=192,
                                              detrend="linear", window="blackman")):
        f, c = je.coherence(jnp.asarray(x), jnp.asarray(y), sampling_rate=10.0, **kw)
        gf, gc = te.coherence(torch.from_numpy(x), torch.from_numpy(y), sampling_rate=10.0,
                              **kw)
        close_to_max(gc, c)
        np.testing.assert_allclose(gf.numpy(), np.asarray(f), rtol=1e-6)


def test_callable_detrend_and_array_window_match_jax(rng):
    x, y = signals(rng, shape=(2, 3000))
    win = np.hanning(300)

    def detr_j(frames):
        return frames - jnp.median(frames, axis=-1, keepdims=True)

    def detr_t(frames):
        return frames - te._median_last(frames)[..., None]

    kw = dict(segment_length=300, overlap_length=100, window=win)
    _, p = je.welch(jnp.asarray(x), detrend=detr_j, **kw)
    _, gp = te.welch(torch.from_numpy(x), detrend=detr_t, **kw)
    close_to_max(gp, p)


def test_estimation_errors_match_jax(rng):
    x = rng.normal(size=512).astype(np.float32)
    cases = [dict(scaling="psd"), dict(average="mode"), dict(overlap_length=256),
             dict(fft_length=100), dict(detrend="quadratic"), dict(segment_length=1024),
             dict(window=np.ones((2, 4)))]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            je.welch(jnp.asarray(x), **kw)
        with pytest.raises(ValueError) as got:
            te.welch(torch.from_numpy(x), **kw)
        assert str(got.value).split(",")[0] == str(want.value).split(",")[0]
    xc = (x + 1j * x).astype(np.complex64)
    with pytest.raises(ValueError, match="onesided=True requires real input"):
        te.csd(torch.from_numpy(xc), torch.from_numpy(xc))


@pytest.mark.parametrize("precenter", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_lombscargle_matches_jax(precenter, normalize, rng):
    t = np.sort(rng.uniform(0, 20, size=300))
    y = np.sin(1.7 * t) + 0.3 * rng.normal(size=300) + 0.2
    w = np.linspace(0.1, 5.0, 120)
    want = np.asarray(je.lombscargle(jnp.asarray(t), jnp.asarray(y), jnp.asarray(w),
                                     precenter=precenter, normalize=normalize))
    got = te.lombscargle(torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(w),
                         precenter=precenter, normalize=normalize)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9 * np.abs(want).max())
    got32 = te.lombscargle(torch.from_numpy(t.astype(np.float32)),
                           torch.from_numpy(y.astype(np.float32)),
                           torch.from_numpy(w.astype(np.float32)))
    assert got32.dtype == torch.float32


def test_vectorstrength_matches_jax(rng):
    events = rng.uniform(0, 10, size=200)
    for period in (0.7, np.array([0.5, 0.7, 1.3])):
        s, ph = je.vectorstrength(jnp.asarray(events), jnp.asarray(period))
        gs, gph = te.vectorstrength(torch.from_numpy(events), period)
        np.testing.assert_allclose(gs.numpy(), np.asarray(s), rtol=0, atol=1e-10)
        np.testing.assert_allclose(gph.numpy(), np.asarray(ph), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="events must be 1-D"):
        te.vectorstrength(torch.zeros(2, 2), 1.0)
    with pytest.raises(ValueError, match="same length"):
        te.lombscargle(torch.zeros(3), torch.zeros(4), torch.ones(2))


@pytest.mark.parametrize("bad", [np.nan, np.inf, 1e30])
@pytest.mark.parametrize("fn,kw", [
    ("welch", dict(detrend=False)), ("welch", {}), ("welch", dict(average="median")),
    ("welch", dict(detrend="linear", average="median")),
    ("welch", dict(onesided=False, detrend=False)), ("csd", dict(average="median")),
    ("periodogram", {})])
def test_non_finite_bins_match_jax(fn, kw, bad, rng):
    """2000 f32 samples with one NaN, inf or overflowing sample at index
    700: the bins the JAX package's complex conj(z) z makes NaN (its NaN im
    part spreads through the products by real scalars promoted to complex)
    are NaN here too, not +inf; the median propagates the NaN. Every bin is
    NaN for these inputs, as the JAX package gives them."""
    x = rng.normal(size=2000).astype(np.float32)
    x[700] = bad
    args = (x, x) if fn == "csd" else (x,)
    want = np.asarray(getattr(je, fn)(*(jnp.asarray(a) for a in args), **kw)[1])
    got = getattr(te, fn)(*(torch.from_numpy(a) for a in args), **kw)[1].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isnan(want.real).all()

