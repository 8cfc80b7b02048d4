"""Where the port's public entry points put a signal.

Each function that takes a signal or spectrum runs it through
`utils.devices.as_signal`: a tensor stays on its own device, anything else
(a numpy array, a list) goes to the CUDA device, and with no CUDA device
that is a RuntimeError naming device='cpu', never a quiet run on the CPU.
Here the card is hidden (torch.cuda.is_available() is False): every entry
point raises on a numpy signal and keeps a CPU tensor on the CPU.
`find_peaks_cwt` is not among them: it is the JAX package's host f64
computation, so it takes a numpy signal on the host.
"""

import importlib

import numpy as np
import pytest
import torch

from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
from nx_signal_tpu_torch.kernels import dft as td
from nx_signal_tpu_torch.models.pipeline import (StftFirChain, WidebandReceiver,
                                                 channelize_power_stream)
from nx_signal_tpu_torch.ops import convolution as tc
from nx_signal_tpu_torch.ops import czt as tczt
from nx_signal_tpu_torch.ops import filters as tfilt
from nx_signal_tpu_torch.ops import find_peaks as tfp
from nx_signal_tpu_torch.ops import iir as tiir
from nx_signal_tpu_torch.ops import lambert_w as tlw
from nx_signal_tpu_torch.ops import ltisys as tlti
from nx_signal_tpu_torch.ops import mixing as tmix
from nx_signal_tpu_torch.ops import peak_finding as tpk
from nx_signal_tpu_torch.ops import resample as tres
from nx_signal_tpu_torch.ops import splines as tspl
from nx_signal_tpu_torch.ops import transforms as tt
from nx_signal_tpu_torch.ops import waveforms as tw
from nx_signal_tpu_torch.ops import wavelets as twav
from nx_signal_tpu_torch.parallel import streaming as tstream
from nx_signal_tpu_torch.spectral import estimation as te
from nx_signal_tpu_torch.spectral import framing as tf
from nx_signal_tpu_torch.spectral import mel as tm
from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT
from nx_signal_tpu_torch.spectral.spectrogram import spectrogram
from nx_signal_tpu_torch.utils import checks

ts = importlib.import_module("nx_signal_tpu_torch.spectral.stft")

_RNG = np.random.default_rng(0)
SIG = _RNG.normal(size=(2, 2048)).astype(np.float32)
SIG1 = SIG[0].copy()
SPEC = (_RNG.normal(size=(2, 13, 129))
        + 1j * _RNG.normal(size=(2, 13, 129))).astype(np.complex64)
FRAMES = _RNG.normal(size=(2, 13, 256)).astype(np.float32)
IMG = _RNG.normal(size=(12, 10)).astype(np.float32)
IMG64 = _RNG.normal(size=(64, 64)).astype(np.float32)
TAPS = np.array([0.25, 0.5, 0.25])
KER2 = np.ones((3, 2), np.float32)
WIN = np.hanning(256)
FOLD = td.fir_dft_fold_weights(TAPS, WIN, 256, True)
DFT_W = torch.as_tensor(td._dft_weights(WIN, 256, 256, True, np.float32))
SFT = ShortTimeFFT(WIN, 64, 1000.0)
SFT_SPEC = (_RNG.normal(size=(2, 129, 36)) + 1j * _RNG.normal(size=(2, 129, 36))).astype(
    np.complex64)
TIMES = np.sort(_RNG.uniform(0, 10, size=64))
BA = ([0.2, 0.4, 0.2], [1.0, -0.4, 0.2])
SOS = np.array([[0.2, 0.4, 0.2, 1.0, -0.4, 0.2], [1.0, 0.0, -1.0, 1.0, 0.1, 0.3]])
# the streaming processors, each with a CPU state for a (2, ...) chunk
PROCESSORS = {
    "StreamingFIR": (tstream.StreamingFIR(TAPS), (2,), SIG),
    "StreamingIIR": (tstream.StreamingIIR(SOS), (2,), SIG),
    "StreamingSTFT": (tstream.StreamingSTFT(WIN, hop=128), (2,), SIG),
    "StreamingISTFT": (tstream.StreamingISTFT(np.hanning(129), hop=64), (2, 13), SPEC),
    "StreamingPFB": (tstream.StreamingPFB(16, taps_per_channel=4), (2,), SIG),
    "StreamingResamplePoly": (tstream.StreamingResamplePoly(1, 2), (2,), SIG),
}

# the simulation: a discrete and a continuous system, their classes, and
# evenly spaced times (a simulation without a signal runs where its times
# sit)
SYSD = ([1.0, 0.5], [1.0, -0.8], 0.1)
SYSC = ([1.0], [1.0, 2.0, 5.0])
SSD = (np.array([[0.5, 0.1], [0.0, 0.3]]), np.array([[1.0], [0.5]]), np.array([[1.0, -1.0]]),
       np.array([[0.2]]), 0.05)
T_EVEN = np.linspace(0.0, 5.0, 2048)
LTI, DLTI = tlti.lti(*SYSC), tlti.dlti(*SYSD[:2], dt=0.1)
TF_C, SS_D = tlti.TransferFunction(*SYSC), tlti.StateSpace(*SSD[:4], dt=0.05)
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
    "lfilter": (lambda s: tiir.lfilter(*BA, s), SIG),
    "lfilter_order3": (lambda s: tiir.lfilter([0.1, 0.2, 0.2, 0.1], [1.0, -0.5, 0.2, -0.1], s),
                       SIG),
    "filtfilt": (lambda s: tiir.filtfilt(*BA, s), SIG),
    "sosfilt": (lambda s: tiir.sosfilt(SOS, s), SIG),
    "sosfiltfilt": (lambda s: tiir.sosfiltfilt(SOS, s), SIG),
    "upfirdn": (lambda s: tres.upfirdn(TAPS, s, 2, 3), SIG),
    "resample_poly": (lambda s: tres.resample_poly(s, 1, 3), SIG),
    "resample": (lambda s: tres.resample(s, 1000), SIG),
    "decimate": (lambda s: tres.decimate(s, 3, ftype="fir"), SIG),
    "pfb_analyze": (lambda s: tres.pfb_analyze(s, 16, taps_per_channel=4), SIG),
    "mix_down": (lambda s: tmix.mix_down(s, 1000.0, 8000.0), SIG),
    "demodulate_channel": (lambda s: tmix.demodulate_channel(
        s, 1000.0, 8000.0, bandwidth=500.0, decimation=4), SIG),
    "hilbert": (lambda s: tt.hilbert(s), SIG),
    "hilbert2": (lambda s: tt.hilbert2(s), IMG),
    "envelope": (lambda s: tt.envelope(s), SIG),
    "sinc": (lambda s: tw.sinc(s), SIG),
    "sawtooth": (lambda s: tw.sawtooth(s, width=0.3), SIG),
    "square": (lambda s: tw.square(s, duty=0.3), SIG),
    "gaussian_pulse": (lambda s: tw.gaussian_pulse(s).quadrature, SIG),
    "gausspulse": (lambda s: tw.gausspulse(s), SIG),
    "chirp": (lambda s: tw.chirp(s, 1.0, 10.0, 5.0), SIG),
    "polynomial_sweep": (lambda s: tw.polynomial_sweep(s, [0.1, 2.0, 1.0]), TIMES),
    "sweep_poly": (lambda s: tw.sweep_poly(s, [0.1, 2.0, 1.0]), TIMES),
    "argrelmin": (lambda s: tpk.argrelmin(s, axis=1).indices, SIG),
    "argrelmax": (lambda s: tpk.argrelmax(s, axis=1, order=3).indices, SIG),
    "argrelextrema": (lambda s: tpk.argrelextrema(s, torch.less_equal).indices, SIG),
    "cwt": (lambda s: twav.cwt(s, twav.ricker, [1.0, 4.0]), SIG1),
    "find_peaks": (lambda s: tfp.find_peaks(s, distance=5, width=1.0).indices, SIG1),
    "peak_prominences": (lambda s: tfp.peak_prominences(s, [3, 10])[0], SIG1),
    "peak_widths": (lambda s: tfp.peak_widths(s, [3, 10])[0], SIG1),
    "czt": (lambda s: tczt.czt(s, 64), SIG),
    "czt_bluestein": (lambda s: tczt.czt(s, 2048), SIG),
    "zoom_fft": (lambda s: tczt.zoom_fft(s, [0.1, 0.3], 32), SIG),
    "CZT": (lambda s: tczt.CZT(2048, 16)(s), SIG),
    "ZoomFFT": (lambda s: tczt.ZoomFFT(2048, [0.1, 0.3], 16)(s), SIG),
    "lambert_w": (lambda s: tlw.lambert_w(s, -1), SIG),
    "gauss_spline": (lambda s: tspl.gauss_spline(s, 3), SIG),
    "cubic_bspline": (lambda s: tspl.cubic_bspline(s), SIG),
    "quadratic_bspline": (lambda s: tspl.quadratic_bspline(s), SIG),
    "symiirorder1": (lambda s: tspl.symiirorder1(s, 0.5, 0.3), SIG),
    "symiirorder2": (lambda s: tspl.symiirorder2(s, 0.5, 0.3), SIG),
    "cspline1d": (lambda s: tspl.cspline1d(s), SIG),
    "cspline1d_smooth": (lambda s: tspl.cspline1d(s, 2.0), SIG),
    "qspline1d": (lambda s: tspl.qspline1d(s), SIG),
    "cspline1d_eval": (lambda s: tspl.cspline1d_eval(s, np.linspace(-5, 2100, 64)), SIG1),
    "qspline1d_eval": (lambda s: tspl.qspline1d_eval(s, np.linspace(-5, 2100, 64)), SIG1),
    "cspline2d": (lambda s: tspl.cspline2d(s, 3.0), IMG64),
    "qspline2d": (lambda s: tspl.qspline2d(s), IMG),
    "sepfir2d": (lambda s: tspl.sepfir2d(s, [1.0, 4.0, 1.0], [1.0, 2.0, 4.0, 2.0, 1.0]), IMG),
    "spline_filter": (lambda s: tspl.spline_filter(s), IMG64),
    "WidebandReceiver": (lambda s: WidebandReceiver(n_channels=16, frame_length=32, hop=16)(s),
                         SIG),
    "count_nonfinite": (lambda s: checks.count_nonfinite(s), SIG),
    "assert_all_finite": (lambda s: checks.assert_all_finite(s), SIG),
    "dlsim": (lambda s: tlti.dlsim(SYSD, s)[1], SIG1),
    "dlsim_ss": (lambda s: tlti.dlsim(SSD, s, x0=[0.3, -0.2])[2], SIG1),
    "lsim": (lambda s: tlti.lsim(SYSC, s, T_EVEN)[1], SIG1),
    "lsim_interp_false": (lambda s: tlti.lsim(SYSC, s, T_EVEN, interp=False)[2], SIG1),
    "lsim_no_input": (lambda s: tlti.lsim(SYSC, None, s, x0=[1.0, 0.0])[1], T_EVEN),
    "impulse": (lambda s: tlti.impulse(SYSC, t=s)[1], T_EVEN),
    "step": (lambda s: tlti.step(SYSC, t=s)[1], T_EVEN),
    "dimpulse": (lambda s: tlti.dimpulse(SYSD, t=s)[1][0], T_EVEN),
    "dstep": (lambda s: tlti.dstep(SSD, t=s)[1][0], T_EVEN),
    "lti.output": (lambda s: LTI.output(s, T_EVEN)[1], SIG1),
    "lti.impulse": (lambda s: LTI.impulse(T=s)[1], T_EVEN),
    "lti.step": (lambda s: LTI.step(T=s)[1], T_EVEN),
    "dlti.output": (lambda s: DLTI.output(s)[1], SIG1),
    "dlti.impulse": (lambda s: DLTI.impulse(t=s)[1][0], T_EVEN),
    "dlti.step": (lambda s: DLTI.step(t=s)[1][0], T_EVEN),
    "TransferFunction.output": (lambda s: TF_C.output(s, T_EVEN)[1], SIG1),
    "TransferFunction.impulse": (lambda s: TF_C.impulse(t=s)[1], T_EVEN),
    "TransferFunction.step": (lambda s: TF_C.step(t=s)[1], T_EVEN),
    "StateSpace.output": (lambda s: SS_D.output(s)[2], SIG1),
    "StateSpace.impulse": (lambda s: SS_D.impulse(t=s)[1][0], T_EVEN),
    "StateSpace.step": (lambda s: SS_D.step(t=s)[1][0], T_EVEN),
}
for _name, (_proc, _batch, _chunk) in PROCESSORS.items():
    ENTRY_POINTS[f"{_name}.process"] = (
        lambda s, p=_proc, b=_batch: p.process(p.init_state(b[:1], device="cpu"), s)[1], _chunk)


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


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_init_state_makes_its_zeros_on_the_card_unless_asked_for_the_cpu(name, no_card):
    proc, batch, _ = PROCESSORS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        proc.init_state(batch[:1])
    state = proc.init_state(batch[:1], device="cpu")
    assert state.device.type == "cpu" and not state.any()


def test_channelize_power_stream_puts_its_chunks_on_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        channelize_power_stream([SIG], 16, taps_per_channel=4)
    power, frames = channelize_power_stream([SIG], 16, taps_per_channel=4, device="cpu")
    assert power.device.type == "cpu" and frames == 2048 // 16


# a simulation without a signal or times: on `device`, where None is the card
NO_SIGNAL = {
    "impulse": lambda **kw: tlti.impulse(SYSC, **kw)[1],
    "step": lambda **kw: tlti.step(SYSC, n=50, **kw)[1],
    "dimpulse": lambda **kw: tlti.dimpulse(SSD, n=50, **kw)[1][0],
    "dstep": lambda **kw: tlti.dstep(SYSD, **kw)[1][0],
    "lsim_no_input": lambda **kw: tlti.lsim(SYSC, None, T_EVEN, x0=[1.0, 0.0], **kw)[1],
    "lti.impulse": lambda **kw: LTI.impulse(**kw)[1],
    "lti.step": lambda **kw: LTI.step(**kw)[1],
    "lti.output_no_input": lambda **kw: LTI.output(None, T_EVEN, X0=[1.0, 0.0], **kw)[1],
    "dlti.impulse": lambda **kw: DLTI.impulse(**kw)[1][0],
    "dlti.step": lambda **kw: DLTI.step(**kw)[1][0],
    "TransferFunction.step": lambda **kw: TF_C.step(**kw)[1],
    "TransferFunction.output_no_input": lambda **kw: TF_C.output(0.0, T_EVEN, x0=[1.0, 0.0],
                                                                 **kw)[1],
    "StateSpace.impulse": lambda **kw: SS_D.impulse(**kw)[1][0],
}


@pytest.mark.parametrize("name", sorted(NO_SIGNAL))
def test_a_simulation_without_a_signal_runs_on_the_card_unless_asked(name, no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NO_SIGNAL[name]()
    out = NO_SIGNAL[name](device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float64
