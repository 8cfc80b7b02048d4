"""Parity of the PyTorch port's spectral/mel.py and the log-mel front end
with the JAX package, on the CPU.

Tolerances:
* mel_filters: 1e-5 x max — the same f32 formulas, but torch's and XLA's
  exp differ by an ulp (up to 2e-6 at the log-spaced mel edges, which the
  ramps then divide by a bandwidth of ~100 Hz): measured 6.4e-6 of the max.
* stft_to_mel / LogMelFrontend: 1e-5 absolute on the normalized log-mel
  values (log10 of f32 powers that agree to ~1e-6 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.models.pipeline import LogMelFrontend as JaxLogMel
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu.spectral import mel as jm
from nx_signal_tpu.spectral.stft import stft as jax_stft
from nx_signal_tpu_torch.models.pipeline import LogMelFrontend
from nx_signal_tpu_torch.spectral import mel as tm


@pytest.mark.parametrize("fft_length,mel_bins,rate", [(16, 3, 8000.0), (512, 80, 16000.0),
                                                      (400, 128, 16000.0),
                                                      (1024, 64, 44100.0)])
def test_mel_filters(fft_length, mel_bins, rate):
    want = np.asarray(jm.mel_filters(fft_length, mel_bins, rate))
    got = tm.mel_filters(fft_length, mel_bins, rate, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_mel_filters_options():
    kw = dict(max_mel=2000.0, mel_frequency_spacing=50.0)
    want = np.asarray(jm.mel_filters(256, 20, 8000.0, **kw))
    got = tm.mel_filters(256, 20, 8000.0, device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("mel_bins", [40, 80])
def test_stft_to_mel(onesided, mel_bins, rng):
    x = rng.normal(size=(2, 8000)).astype(np.float32)
    w = np.asarray(jw.hann(256))
    z = jax_stft(jnp.asarray(x), w, sampling_rate=8000.0, fft_length=256,
                 overlap_length=128, onesided=onesided).z
    z = np.asarray(z).astype(np.complex64)
    want = np.asarray(jm.stft_to_mel(jnp.asarray(z), 8000.0, fft_length=256,
                                     mel_bins=mel_bins))
    got = tm.stft_to_mel(torch.from_numpy(z), 8000.0, fft_length=256, mel_bins=mel_bins)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("params", [dict(), dict(frame_length=256, hop_length=128,
                                                 fft_length=256, mel_bins=40,
                                                 sampling_rate=8000.0),
                                    dict(fft_length=400)])   # Whisper's n_fft: 2^4 * 5^2
def test_log_mel_frontend(params, rng):
    x = rng.normal(size=(2, 16000)).astype(np.float32)
    want = np.asarray(JaxLogMel(**params)(jnp.asarray(x)))
    got = LogMelFrontend(**params)(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
