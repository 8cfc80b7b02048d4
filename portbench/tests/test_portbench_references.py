"""The benchmark's designs and references against scipy.signal and numpy at
small sizes, and their controls measurably less precise."""

import numpy as np
import pytest
import scipy.signal
import torch

from conftest import ROOT
from portbench.core import design
from portbench.core.spec import Bench

BENCH = Bench(ROOT)
CHAIN = BENCH.module("references", "chain_power")
ROUND = BENCH.module("references", "roundtrip")


def test_designs_are_scipys():
    np.testing.assert_allclose(design.hann(512), scipy.signal.windows.hann(512, sym=False),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(design.hann(64, periodic=False),
                               scipy.signal.windows.hann(64), rtol=0, atol=1e-15)
    np.testing.assert_allclose(design.lowpass_firwin(255, 2000.0, 48000.0),
                               scipy.signal.firwin(255, 2000.0, fs=48000.0),
                               rtol=0, atol=1e-15)


def _signal(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("s0, s1", [(0, 4000), (300, 1700), (3500, 4000)])
def test_fir_same_is_numpy_convolve_same(s0, s1):
    x, taps = _signal((3, 4000)), design.lowpass_firwin(63, 2000.0, 48000.0)
    want = np.stack([np.convolve(r, taps)[(63 - 1) // 2:][:4000] for r in x])[:, s0:s1]
    got = CHAIN.fir_same(torch.from_numpy(x), torch.from_numpy(taps), s0, s1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_chain_power_is_scipys_filter_then_spectrogram():
    x, taps, win = _signal((2, 6000)), design.lowpass_firwin(255, 2000.0, 48000.0), \
        design.hann(512)
    y = np.stack([np.convolve(r, taps)[127:][:6000] for r in x])
    _, _, spec = scipy.signal.spectrogram(y, window=win, nperseg=512, noverlap=384,
                                          nfft=512, detrend=False, scaling="spectrum",
                                          mode="magnitude")
    want = (spec * win.sum()) ** 2            # |rfft(frame * w)|^2
    frames = (6000 - 512) // 128 + 1
    got = CHAIN.power(torch.from_numpy(x), torch.from_numpy(taps), torch.from_numpy(win),
                      128, 512, 0, frames).numpy()
    np.testing.assert_allclose(got, np.swapaxes(want, -1, -2), rtol=1e-9,
                               atol=1e-9 * want.max())


def test_round_trip_is_scipys_stft_and_istft():
    x, win = _signal((2, 8192)), design.hann(512)
    _, _, zs = scipy.signal.stft(x, window=win, nperseg=512, noverlap=384, nfft=512,
                                 boundary=None, padded=False, scaling="psd", detrend=False)
    z = ROUND.stft(torch.from_numpy(x), torch.from_numpy(win), 128, 512)
    # scipy's 'psd' scaling divides by sqrt(sum(w^2)) at fs = 1
    np.testing.assert_allclose(z.numpy(), np.swapaxes(zs, -1, -2) * np.sqrt((win ** 2).sum()),
                               rtol=0, atol=1e-10)
    y = ROUND.istft(z, torch.from_numpy(win), 128, 512).numpy()
    _, ys = scipy.signal.istft(zs, window=win, nperseg=512, noverlap=384, nfft=512,
                               boundary=False, scaling="psd")
    n = min(y.shape[-1], ys.shape[-1])
    np.testing.assert_allclose(y[:, 512:n - 512], ys[:, 512:n - 512], rtol=0, atol=1e-10)
    np.testing.assert_allclose(y[:, 512:n - 512], x[:, 512:n - 512], rtol=0, atol=1e-10)


def test_the_controls_are_tf32():
    x = torch.from_numpy(_signal((2, 8192))).float()
    taps = torch.from_numpy(design.lowpass_firwin(255, 2000.0, 48000.0)).float()
    win = torch.from_numpy(design.hann(512)).float()
    tie = torch.tensor([1.0 + 2.0 ** -11])     # half way: rounds away from zero
    assert torch.equal(CHAIN.tf32(tie), torch.tensor([1.0 + 2.0 ** -10]))
    p = CHAIN.power(x, taps, win, 128, 512, 0, (8192 - 512) // 128 + 1)
    pc = CHAIN.control_power(x, taps, win, 128, 512)
    rel = float((pc.double() - p).abs().max() / p.abs().max())
    assert 1e-5 < rel < 1e-2                   # TF32 keeps about three digits
    z, y = ROUND.control_roundtrip(x, win, 128, 512)
    zr = ROUND.stft(x, win, 128, 512)
    assert 1e-5 < float((z - zr).abs().max() / zr.abs().max()) < 1e-2
    yr = ROUND.istft(zr, win, 128, 512)
    assert 1e-5 < float((y - yr)[:, 512:-512].abs().max() / yr.abs().max()) < 1e-2
