"""Where the port's public entry points put a signal.

Each function that takes a signal or spectrum runs it through
`utils.devices.as_signal`: a tensor stays on its own device, anything else
(a numpy array, a list) goes to the CUDA device, and with no CUDA device
that is a RuntimeError naming device='cpu', never a quiet run on the CPU.
Here the card is hidden (torch.cuda.is_available() is False): every entry
point raises on a numpy signal and keeps a CPU tensor on the CPU.
"""

import numpy as np
import pytest
import torch

from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
from nx_signal_tpu_torch.kernels import dft as td
from nx_signal_tpu_torch.models.pipeline import StftFirChain
from nx_signal_tpu_torch.ops import convolution as tc
from nx_signal_tpu_torch.ops import filters as tfilt
from nx_signal_tpu_torch.ops import transforms as tt
from nx_signal_tpu_torch.spectral import estimation as te
from nx_signal_tpu_torch.spectral import framing as tf
from nx_signal_tpu_torch.spectral import mel as tm
from nx_signal_tpu_torch.spectral import stft as ts
from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT
from nx_signal_tpu_torch.spectral.spectrogram import spectrogram

_RNG = np.random.default_rng(0)
SIG = _RNG.normal(size=(2, 2048)).astype(np.float32)
SPEC = (_RNG.normal(size=(2, 13, 129))
        + 1j * _RNG.normal(size=(2, 13, 129))).astype(np.complex64)
FRAMES = _RNG.normal(size=(2, 13, 256)).astype(np.float32)
IMG = _RNG.normal(size=(12, 10)).astype(np.float32)
TAPS = np.array([0.25, 0.5, 0.25])
KER2 = np.ones((3, 2), np.float32)
WIN = np.hanning(256)
FOLD = td.fir_dft_fold_weights(TAPS, WIN, 256, True)
DFT_W = torch.as_tensor(td._dft_weights(WIN, 256, 256, True, np.float32))
SFT = ShortTimeFFT(WIN, 64, 1000.0)
SFT_SPEC = (_RNG.normal(size=(2, 129, 36)) + 1j * _RNG.normal(size=(2, 129, 36))).astype(
    np.complex64)
TIMES = np.sort(_RNG.uniform(0, 10, size=64))

# name -> (function of the signal, the signal as numpy)
ENTRY_POINTS = {
    "stft": (lambda s: ts.stft(s, WIN, overlap_length=128, onesided=True).z, SIG),
    "istft": (lambda s: ts.istft(s, WIN, overlap_length=128, onesided=True), SPEC),
    "pad_for_windowing": (lambda s: tf.pad_for_windowing(s, 256, "reflect"), SIG),
    "as_windowed": (lambda s: tf.as_windowed(s, window_length=256, stride=128), SIG),
    "overlap_and_add": (lambda s: tf.overlap_and_add(s, overlap_length=128), FRAMES),
    "stft_to_mel": (lambda s: tm.stft_to_mel(s, 8000.0, fft_length=256, mel_bins=20), SPEC),
    "blocked_frame_matmul": (lambda s: td.blocked_frame_matmul(
        s, DFT_W, window_length=256, stride=128, num_frames=13), SIG),
    "framed_dft": (lambda s: td.framed_dft(s, WIN, stride=128, n_fft=256, onesided=True), SIG),
    "framed_dft_dense": (lambda s: td.framed_dft(s, WIN, stride=128, n_fft=1031), SIG),
    "framed_idft": (lambda s: td.framed_idft(s, WIN, n_fft=256, onesided=True), SPEC),
    "fir_framed_dft": (lambda s: td.fir_framed_dft(s, TAPS, WIN, stride=128, n_fft=256,
                                                   onesided=True, output="power"), SIG),
    "fir_framed_dft_shared": (lambda s: td.fir_framed_dft_shared(
        s, TAPS, stride=128, n_fft=256, window_coeffs=(0.5, -0.5), onesided=True,
        output="power"), SIG),
    "convolve": (lambda s: tc.convolve(s, TAPS[None], mode="same"), SIG),
    "correlate": (lambda s: tc.correlate(s, TAPS[None], mode="valid", method="fft"), SIG),
    "fftconvolve": (lambda s: tc.fftconvolve(s, TAPS[None]), SIG),
    "oaconvolve": (lambda s: tc.oaconvolve(s, TAPS[None], mode="same"), SIG),
    "convolve2d": (lambda s: tc.convolve2d(s, KER2, mode="same"), IMG),
    "correlate2d": (lambda s: tc.correlate2d(s, KER2, boundary="wrap"), IMG),
    "fir_convolve_1d": (lambda s: tc.fir_convolve_1d(s, TAPS, mode="full"), SIG),
    "deconvolve": (lambda s: tc.deconvolve(s, np.array([1.0, 1.0]))[0],
                   np.array([1.0, 3.0, 3.0, 1.0])),
    "fft_nd": (lambda s: tt.fft_nd(s, axes=[-1]), SIG),
    "ifft_nd": (lambda s: tt.ifft_nd(s, axes=[-1]), SPEC),
    "rfft_nd": (lambda s: tt.rfft_nd(s, axes=[-1], lengths=[4096]), SIG),
    "irfft_nd": (lambda s: tt.irfft_nd(s, axes=[-1], lengths=[256]), SPEC),
    "fir_framed_dft_power_cuda": (lambda s: cuda_dft.fir_framed_dft_power_cuda(
        s, FOLD, stride=128, pad_left=1, num_frames=13, bins=129), SIG),
    "fir_framed_dft_power_tc_cuda": (lambda s: cuda_dft.fir_framed_dft_power_tc_cuda(
        s, FOLD, stride=128, pad_left=1, num_frames=13, bins=129, precision="high"), SIG),
    "framed_fft_cuda": (lambda s: cuda_dft.framed_fft_cuda(s, WIN, stride=128, n_fft=256), SIG),
    "framed_dft_cuda": (lambda s: cuda_dft.framed_dft_cuda(
        s, DFT_W, stride=128, num_frames=15, bins=129), SIG),
    "overlap_add_cuda": (lambda s: cuda_dft.overlap_add_cuda(
        s, stride=128, out_length=13 * 128 + 128), FRAMES),
    "fir_framed_dft_power_shared_cuda": (lambda s: cuda_dft.fir_framed_dft_power_shared_cuda(
        s, td.shared_fold_weights(TAPS, 128, 256), td.shared_twiddles(128, 256), (0.5, -0.5),
        stride=128, pad_left=1, num_frames=15, bins=129), SIG),
    "halo_extend_cuda": (lambda s: cuda_halo.halo_extend_cuda(s, 0, 0, mesh=None), SIG),
    "StftFirChain": (lambda s: StftFirChain.from_numpy(TAPS, WIN, stride=128, n_fft=256,
                                                       device="cpu")(s), SIG),
    "median": (lambda s: tfilt.median(s, kernel_shape=(2, 4)), IMG),
    "wiener": (lambda s: tfilt.wiener(s, kernel_size=3), IMG),
    "order_filter": (lambda s: tfilt.order_filter(s, np.ones((3, 3)), 2), IMG),
    "medfilt": (lambda s: tfilt.medfilt(s, 3), IMG),
    "medfilt2d": (lambda s: tfilt.medfilt2d(s, 3), IMG),
    "savgol_filter": (lambda s: tfilt.savgol_filter(s, 7, 2), SIG),
    "detrend": (lambda s: tfilt.detrend(s), SIG),
    "spectrogram": (lambda s: spectrogram(s, 8000.0)[2], SIG),
    "welch": (lambda s: te.welch(s, segment_length=256)[1], SIG),
    "csd": (lambda s: te.csd(s, SIG[::-1].copy(), segment_length=256)[1], SIG),
    "periodogram": (lambda s: te.periodogram(s)[1], SIG),
    "coherence": (lambda s: te.coherence(s, SIG[::-1].copy(), segment_length=256)[1], SIG),
    "lombscargle": (lambda s: te.lombscargle(s, np.cos(TIMES), [1.0, 2.0]), TIMES),
    "vectorstrength": (lambda s: te.vectorstrength(s, 0.5)[0], TIMES),
    "ShortTimeFFT.stft": (lambda s: SFT.stft(s), SIG),
    "ShortTimeFFT.stft_detrend": (lambda s: SFT.stft_detrend(s, "linear"), SIG),
    "ShortTimeFFT.spectrogram": (lambda s: SFT.spectrogram(s), SIG),
    "ShortTimeFFT.istft": (lambda s: SFT.istft(s), SFT_SPEC),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_puts_a_numpy_signal_on_the_card(name, no_card):
    fn, signal = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(signal)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(signal.tolist())
    out = fn(torch.from_numpy(signal))
    assert out.device.type == "cpu"
