"""Parity of the port's spectrogram (nx_signal_tpu_torch/spectral/
spectrogram.py) with the JAX package's, on the CPU: 1e-4 of the max, the
JAX package's gate for its f32 STFT (f32 contractions or FFTs summed in
another order); frequencies and times at rtol 1e-6."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu_torch.spectral.spectrogram import spectrogram

js = importlib.import_module("nx_signal_tpu.spectral.spectrogram")


@pytest.mark.parametrize("mode", ["psd", "magnitude", "complex"])
@pytest.mark.parametrize("window,length,overlap,fft_length,onesided", [
    ("hann", 256, None, None, True),
    (("kaiser", 6.0), 200, 150, 256, True),
    ("blackmanharris", 128, 64, None, False),
    (("tukey", 0.3), 255, 100, 2048, True),   # past 1024: torch.fft
    ("hamming", 64, 16, 65, True),             # odd n_fft: the Nyquist bin is doubled
])
def test_spectrogram_matches_jax(mode, window, length, overlap, fft_length, onesided, rng):
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    kw = dict(window=window, window_length=length, overlap_length=overlap,
              fft_length=fft_length, mode=mode, onesided=onesided)
    f, t, s = js.spectrogram(jnp.asarray(x), 8000.0, **kw)
    gf, gt, gs = spectrogram(torch.from_numpy(x), 8000.0, **kw)
    want = np.asarray(s)
    assert gs.shape == want.shape and gs.is_complex() == (mode == "complex")
    np.testing.assert_allclose(gs.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(gf.numpy(), np.asarray(f), rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(t), rtol=1e-6)


def test_spectrogram_errors():
    with pytest.raises(ValueError, match="mode must be one of"):
        spectrogram(torch.zeros(512), 1.0, mode="power")


@pytest.mark.parametrize("bad", [np.nan, np.inf, 1e30])
@pytest.mark.parametrize("mode", ["psd", "magnitude"])
def test_non_finite_bins_match_jax(mode, bad, rng):
    """One NaN, inf or overflowing sample: the NaN and inf bins of the JAX
    package (its complex abs is NaN where a part is NaN, torch's is inf
    beside an inf part)."""
    x = rng.normal(size=2000).astype(np.float32)
    x[700] = bad
    want = np.asarray(js.spectrogram(jnp.asarray(x), 1.0, mode=mode)[2])
    got = spectrogram(torch.from_numpy(x), 1.0, mode=mode)[2].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
