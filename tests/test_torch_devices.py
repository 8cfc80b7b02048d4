"""Where the port's public entry points put their data: the one rule of
`utils.devices`.

Each function that takes a signal or spectrum runs it through
`utils.devices.as_signal`: a tensor stays on its own device, anything else
(a numpy array, a list) goes to the CUDA device (ENTRY_POINTS). An entry
point given no tensor at all (sizes, scalars, numpy coefficients, strings:
a window, a filter design, a response, a filterbank, a wavelet, chirp-z
points, a simulation without a signal) builds on the CUDA device unless
given `device=` (NO_TENSOR, NO_SIGNAL). With no CUDA device either is a
RuntimeError naming device='cpu', never a quiet run on the CPU. Here the
card is hidden (torch.cuda.is_available() is False): every entry point
raises on a numpy signal or with no device, and keeps a CPU tensor, or
device='cpu', on the CPU. The functions the JAX package returns as numpy
stay host numpy (HOST_NUMPY: the IIR design, the ltisys conversions and
responses, `find_peaks_cwt`, ...); the rest are exempt with a reason
(EXEMPT). `test_every_registered_function_has_one_place` puts every
function of `registry.FUNCTION_TYPES` in exactly one of these.
"""

import importlib

import numpy as np
import pytest
import torch

from nx_signal_tpu_torch import registry
from nx_signal_tpu_torch.kernels import cuda_dft, cuda_halo
from nx_signal_tpu_torch.kernels import dft as td
from nx_signal_tpu_torch.models.pipeline import (FIRFilterChain, LogMelFrontend,
                                                 SpectrogramPipeline, StftFirChain,
                                                 WhisperLogMel, WidebandReceiver,
                                                 channelize_power_stream, stft_fir_chain)
from nx_signal_tpu_torch.ops import convolution as tc
from nx_signal_tpu_torch.ops import czt as tczt
from nx_signal_tpu_torch.ops import filters as tfilt
from nx_signal_tpu_torch.ops import find_peaks as tfp
from nx_signal_tpu_torch.ops import fir_design as tfd
from nx_signal_tpu_torch.ops import iir as tiir
from nx_signal_tpu_torch.ops import iir_design as tid
from nx_signal_tpu_torch.ops import lambert_w as tlw
from nx_signal_tpu_torch.ops import ltisys as tlti
from nx_signal_tpu_torch.ops import mixing as tmix
from nx_signal_tpu_torch.ops import peak_finding as tpk
from nx_signal_tpu_torch.ops import resample as tres
from nx_signal_tpu_torch.ops import splines as tspl
from nx_signal_tpu_torch.ops import transforms as tt
from nx_signal_tpu_torch.ops import waveforms as tw
from nx_signal_tpu_torch.ops import wavelets as twav
from nx_signal_tpu_torch.ops import windows as twin
from nx_signal_tpu_torch.parallel import streaming as tstream
from nx_signal_tpu_torch.spectral import estimation as te
from nx_signal_tpu_torch.spectral import framing as tf
from nx_signal_tpu_torch.spectral import mel as tm
from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT, closest_STFT_dual_window
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
FOLD = td.fir_dft_fold_weights(TAPS, WIN, 256, True, device="cpu")
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
ZPK_D = tlti.ZerosPolesGain([0.5], [0.8], 1.0, dt=0.1)
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
    "framed_ifft_cuda": (lambda s: cuda_dft.framed_ifft_cuda(s, WIN, n_fft=256), SPEC),
    "framed_dft_cuda": (lambda s: cuda_dft.framed_dft_cuda(
        s, DFT_W, stride=128, num_frames=15, bins=129), SIG),
    "overlap_add_cuda": (lambda s: cuda_dft.overlap_add_cuda(
        s, stride=128, out_length=13 * 128 + 128), FRAMES),
    "fir_framed_dft_power_shared_cuda": (lambda s: cuda_dft.fir_framed_dft_power_shared_cuda(
        s, td.shared_fold_weights(TAPS, 128, 256, device="cpu"),
        td.shared_twiddles(128, 256, device="cpu"), (0.5, -0.5), stride=128, pad_left=1,
        num_frames=15, bins=129), SIG),
    "halo_extend_cuda": (lambda s: cuda_halo.halo_extend_cuda(s, 0, 0, mesh=None), SIG),
    "StftFirChain": (lambda s: StftFirChain.from_numpy(TAPS, WIN, stride=128, n_fft=256,
                                                       device="cpu")(s), SIG),
    "stft_fir_chain": (lambda s: stft_fir_chain(s, TAPS, WIN, fft_length=256,
                                                overlap_length=128)[1], SIG),
    "SpectrogramPipeline": (lambda s: SpectrogramPipeline(frame_length=256,
                                                          fft_length=256)(s)[0], SIG),
    "LogMelFrontend": (lambda s: LogMelFrontend()(s), SIG),
    "WhisperLogMel": (lambda s: WhisperLogMel(80, device="cpu")(s), SIG),
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
    "ZerosPolesGain.output": (lambda s: ZPK_D.output(s)[1], SIG1),
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


def _window_case(name, *args, **kw):
    return lambda **dev: getattr(twin, name)(*args, **kw, **dev)


# an entry point given no tensor: on `device`, where None is the card; each
# case takes device=... and returns a tensor or a tuple holding tensors
NO_TENSOR = {
    **{name: _window_case(name, 9) for name in (
        "rectangular", "bartlett", "triangular", "blackman", "hamming", "hann", "kaiser",
        "blackmanharris", "nuttall", "flattop", "bohman", "cosine", "barthann", "parzen",
        "lanczos", "tukey", "exponential", "taylor", "chebwin", "boxcar", "triang")},
    "general_cosine": _window_case("general_cosine", 9, [0.5, 0.3, 0.2]),
    "general_hamming": _window_case("general_hamming", 9, 0.6),
    "gaussian": _window_case("gaussian", 9, 1.5),
    "general_gaussian": _window_case("general_gaussian", 9, 1.5, 2.0),
    "dpss": _window_case("dpss", 16, 2.5, 3),
    "kaiser_bessel_derived": _window_case("kaiser_bessel_derived", 8, 4.0),
    "get_window": _window_case("get_window", "hann", 16, periodic=True),
    "get_window_kaiser": _window_case("get_window", ("kaiser", 8.0), 16),
    "get_window_rectangular": _window_case("get_window", "rectangular", 16),
    "firwin": lambda **kw: tfilt.firwin(31, [0.2], **kw),
    "firwin_bandpass": lambda **kw: tfilt.firwin(31, [0.2, 0.5], pass_zero=False,
                                                 window="blackman", **kw),
    "firwin_2d": lambda **kw: tfilt.firwin_2d((5, 7), ("hamming", "hann"), fc=0.4, **kw),
    "firwin_2d_circular": lambda **kw: tfilt.firwin_2d((7, 5), "hamming", fc=0.3,
                                                       circular=True, **kw),
    "savgol_coeffs": lambda **kw: tfilt.savgol_coeffs(7, 2, **kw),
    "freqz": lambda **kw: tfilt.freqz(TAPS, n_freqs=64, **kw),
    "freqz_iir": lambda **kw: tfilt.freqz(*BA, n_freqs=64, whole=True, **kw),
    "sosfreqz": lambda **kw: tfilt.sosfreqz(SOS, n_freqs=64, **kw),
    "freqz_sos": lambda **kw: tfilt.freqz_sos(SOS, n_freqs=64, **kw),
    "freqz_zpk": lambda **kw: tfilt.freqz_zpk([0.5, -1.0], [0.3 + 0.2j, 0.3 - 0.2j], 2.0,
                                              n_freqs=64, **kw),
    "freqs": lambda **kw: tfilt.freqs(*SYSC, 20, **kw),
    "freqs_given_w": lambda **kw: tfilt.freqs(*SYSC, np.array([0.1, 1.0, 3.0]), **kw),
    "freqs_zpk": lambda **kw: tfilt.freqs_zpk([-0.5], [-1.0 + 2.0j, -1.0 - 2.0j], 3.0, 20,
                                              **kw),
    "group_delay": lambda **kw: tfilt.group_delay(*BA, n_freqs=64, **kw),
    "max_len_seq": lambda **kw: tfilt.max_len_seq(5, **kw),
    "firwin2": lambda **kw: tfd.firwin2(31, [0.0, 0.5, 1.0], [1.0, 1.0, 0.0], **kw),
    "firls": lambda **kw: tfd.firls(31, [0.0, 0.3, 0.5, 1.0], [1.0, 1.0, 0.0, 0.0], **kw),
    "remez": lambda **kw: tfd.remez(31, [0.0, 0.2, 0.3, 0.5], [1.0, 0.0], sampling_rate=1.0,
                                    **kw),
    "minimum_phase": lambda **kw: tfd.minimum_phase(TAPS, **kw),
    "mel_filters": lambda **kw: tm.mel_filters(256, 20, 8000.0, **kw),
    "fft_frequencies": lambda **kw: ts.fft_frequencies(8000.0, fft_length=256, **kw),
    "unit_impulse": lambda **kw: tw.unit_impulse((3, 4), index="midpoint", **kw),
    "ricker": lambda **kw: twav.ricker(33, 2.5, **kw),
    "morlet": lambda **kw: twav.morlet(33, 6.0, 1.0, **kw),
    "morlet2": lambda **kw: twav.morlet2(33, 2.0, **kw),
    "qmf": lambda **kw: twav.qmf(TAPS, **kw),
    "czt_points": lambda **kw: tczt.czt_points(16, np.exp(-0.02j), 0.9 + 0.1j, **kw),
    "CZT.points": lambda **kw: tczt.CZT(64, 16).points(**kw),
    "ZoomFFT.points": lambda **kw: tczt.ZoomFFT(64, [0.1, 0.3], 16).points(**kw),
    "_CztPlan.points": lambda **kw: tczt._CztPlan(64, 16).points(**kw),
    "fir_dft_fold_weights": lambda **kw: td.fir_dft_fold_weights(TAPS, WIN, 256, True, **kw),
    "shared_fold_weights": lambda **kw: td.shared_fold_weights(TAPS, 128, 256, **kw),
    "shared_twiddles": lambda **kw: td.shared_twiddles(128, 256, **kw),
    "FIRFilterChain.design": lambda **kw: FIRFilterChain(num_taps=31).design(**kw),
    "WhisperLogMel.buffers": lambda **kw: tuple(WhisperLogMel(80, **kw).buffers()),
}


def _tensors(out):
    """Every tensor in a result (a tensor, or tuples, lists, dicts and
    result objects of them)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _tensors(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _tensors(v)]
    if hasattr(out, "__dict__") and not isinstance(out, type):
        return _tensors(vars(out))
    return []


@pytest.mark.parametrize("name", sorted(NO_TENSOR))
def test_an_entry_point_given_no_tensor_builds_on_the_card_unless_asked(name, no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NO_TENSOR[name]()
    tensors = _tensors(NO_TENSOR[name](device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_a_response_runs_where_its_tensor_coefficients_are(no_card):
    """`device=` is used only where no coefficient is a tensor: a CPU
    tensor among numpy coefficients keeps the response on the CPU."""
    b, a = torch.tensor([0.2, 0.4, 0.2], dtype=torch.float64), np.array(BA[1])
    for out in (tfilt.freqz(b, a), tfilt.freqz(BA[0], torch.from_numpy(a)),
                tfilt.group_delay(BA[0], torch.from_numpy(a)), tfilt.sosfreqz(torch.tensor(SOS)),
                tfilt.freqz_zpk([0.5], torch.tensor([0.3 + 0.2j]), 2.0),
                tfilt.freqs(b, a, 20), tfilt.freqs_zpk([-0.5], [-1.0], 3.0, torch.ones(3))):
        assert all(t.device.type == "cpu" for t in _tensors(out))


# functions the JAX package returns as numpy (or plain Python values)
# computed on the host: each returns no tensor, and needs no card
SS_C = tid.tf2zpk(*BA)
HOST_NUMPY = {
    "band_stop_obj": lambda: tid.band_stop_obj(0.25, 0, np.array([0.2, 0.5]),
                                               np.array([0.3, 0.4]), 3.0, 40.0, "butter"),
    "bessel": lambda: tid.bessel(4, 0.2),
    "besselap": lambda: tid.besselap(4),
    "bilinear_zpk": lambda: tid.bilinear_zpk([], [-1.0], 1.0, 2.0),
    "buttap": lambda: tid.buttap(4),
    "butter": lambda: tid.butter(4, 0.2, output="sos"),
    "buttord": lambda: tid.buttord(0.2, 0.3, 3.0, 40.0),
    "cheb1ap": lambda: tid.cheb1ap(4, 1.0),
    "cheb1ord": lambda: tid.cheb1ord(0.2, 0.3, 3.0, 40.0),
    "cheb2ap": lambda: tid.cheb2ap(4, 40.0),
    "cheb2ord": lambda: tid.cheb2ord(0.2, 0.3, 3.0, 40.0),
    "cheby1": lambda: tid.cheby1(4, 1.0, 0.2),
    "cheby2": lambda: tid.cheby2(4, 40.0, 0.2, output="zpk"),
    "ellip": lambda: tid.ellip(4, 1.0, 40.0, 0.2),
    "ellipap": lambda: tid.ellipap(4, 1.0, 40.0),
    "ellipord": lambda: tid.ellipord(0.2, 0.3, 3.0, 40.0),
    "iircomb": lambda: tid.iircomb(1000.0, 30.0, fs=8000.0),
    "iirdesign": lambda: tid.iirdesign(0.2, 0.3, 3.0, 40.0),
    "iirfilter": lambda: tid.iirfilter(4, 0.2),
    "iirnotch": lambda: tid.iirnotch(0.2, 30.0),
    "iirpeak": lambda: tid.iirpeak(0.2, 30.0),
    "lp2bp": lambda: tid.lp2bp([1.0], [1.0, 1.0]),
    "lp2bp_zpk": lambda: tid.lp2bp_zpk([], [-1.0], 1.0),
    "lp2bs": lambda: tid.lp2bs([1.0], [1.0, 1.0]),
    "lp2bs_zpk": lambda: tid.lp2bs_zpk([], [-1.0], 1.0),
    "lp2hp": lambda: tid.lp2hp([1.0], [1.0, 1.0]),
    "lp2hp_zpk": lambda: tid.lp2hp_zpk([], [-1.0], 1.0),
    "lp2lp": lambda: tid.lp2lp([1.0], [1.0, 1.0]),
    "lp2lp_zpk": lambda: tid.lp2lp_zpk([], [-1.0], 1.0),
    "sos2tf": lambda: tid.sos2tf(SOS),
    "sos2zpk": lambda: tid.sos2zpk(SOS),
    "tf2sos": lambda: tid.tf2sos(*BA),
    "tf2zpk": lambda: tid.tf2zpk(*BA),
    "zpk2sos": lambda: tid.zpk2sos(*SS_C),
    "zpk2tf": lambda: tid.zpk2tf(*SS_C),
    "abcd_normalize": lambda: tlti.abcd_normalize(*SSD[:4]),
    "bilinear": lambda: tlti.bilinear(*SYSC, fs=10.0),
    "bode": lambda: tlti.bode(SYSC, n=16),
    "cont2discrete": lambda: tlti.cont2discrete(SYSC, 0.1),
    "dbode": lambda: tlti.dbode(SYSD, n=16),
    "dfreqresp": lambda: tlti.dfreqresp(SYSD, n=16),
    "findfreqs": lambda: tlti.findfreqs(*SYSC, 16),
    "freqresp": lambda: tlti.freqresp(SYSC, n=16),
    "invres": lambda: tlti.invres([1.0, 2.0], [-1.0, -3.0], []),
    "invresz": lambda: tlti.invresz([1.0, 2.0], [0.5, 0.2], []),
    "normalize": lambda: tlti.normalize(*BA),
    "place_poles": lambda: tlti.place_poles(np.array([[0.0, 1.0], [-2.0, -3.0]]),
                                            np.array([[0.0], [1.0]]), [-4.0, -5.0]),
    "residue": lambda: tlti.residue([1.0, 2.0], [1.0, 4.0, 3.0]),
    "residuez": lambda: tlti.residuez(*BA),
    "ss2tf": lambda: tlti.ss2tf(*SSD[:4]),
    "ss2zpk": lambda: tlti.ss2zpk(*SSD[:4]),
    "tf2ss": lambda: tlti.tf2ss(*SYSC),
    "unique_roots": lambda: tlti.unique_roots([1.0, 1.0001, 2.0]),
    "zpk2ss": lambda: tlti.zpk2ss(*SS_C),
    "lfilter_zi": lambda: tiir.lfilter_zi(*BA),
    "sosfilt_zi": lambda: tiir.sosfilt_zi(SOS),
    "lfiltic": lambda: tiir.lfiltic(*BA, [1.0, 0.5]),
    "kaiserord": lambda: tfd.kaiserord(60.0, 0.1),
    "kaiser_beta": lambda: tfd.kaiser_beta(60.0),
    "kaiser_atten": lambda: tfd.kaiser_atten(31, 0.1),
    "gammatone": lambda: tfilt.gammatone(440.0, "iir", fs=16000.0),
    "correlation_lags": lambda: tc.correlation_lags(100, 31, "same"),
    "find_peaks_cwt": lambda: tfp.find_peaks_cwt(np.sin(np.linspace(0, 20, 400)),
                                                 np.arange(1, 8)),
    "toeplitz_band": lambda: td.toeplitz_band(TAPS, 16),
    "check_cola": lambda: ts.check_cola("hann", 64, 32),
    "check_nola": lambda: ts.check_nola(WIN, 256, 128),
    "check_COLA": lambda: ts.check_COLA(("kaiser", 6.0), 64, 32),
    "check_NOLA": lambda: ts.check_NOLA("boxcar", 32, 0),
    "closest_STFT_dual_window": lambda: closest_STFT_dual_window(WIN, 64),
}


@pytest.mark.parametrize("name", sorted(HOST_NUMPY))
def test_a_host_function_returns_no_tensor_and_needs_no_card(name, no_card):
    assert not _tensors(HOST_NUMPY[name]())


# registered names outside the rule, each with its reason
EXEMPT = {
    "BadCoefficients": "a warning class",
    "Peaks": "find_peaks's result type",
    "FailureDetected": "an exception class",
    "choose_conv_method": "returns a method name",
    "good_matmul_fft_length": "returns a flag",
    "fft_kernel_takes": "returns a flag",
    "ifft_kernel_takes": "returns a flag",
    "recognize_cosine_window": "returns a window's coefficients as a Python tuple",
    "pfb_footprint_bytes": "returns a byte count",
    "halo_plan": "kernel E's ordering plan, host Python",
    "close_halo_buffers": "frees kernel E's buffers",
    **dict.fromkeys(
        ["gather_blocks", "sharded_convolve_same", "sharded_fir_framed_dft_power",
         "sharded_istft", "sharded_oaconvolve_same", "sharded_pfb_analyze",
         "sharded_resample_poly", "sharded_sosfilt", "sharded_stft", "sharded_upfirdn",
         "sharded_coherence", "sharded_csd", "sharded_welch"],
        "needs a process group; tests/test_torch_sharded.py and "
        "test_torch_sharded_estimation.py run it on CPU tensors in gloo ranks"),
    **dict.fromkeys(
        ["channel_block_sharding", "make_dsp_mesh", "mesh_device", "initialize",
         "make_pod_mesh", "process_block_range"],
        "a mesh or process group: the card unless device_type='cpu' "
        "(test_torch_sharded.py::test_mesh_needs_a_group_and_the_card_unless_asked, "
        "test_torch_multihost.py)"),
    "heartbeat": "probes every card, or the CPU with device='cpu' (test_torch_failure.py)",
    "run_with_recovery": "a driver loop around the caller's steps",
    "channelize_power_stream": "a stream of blocks and `device=`: "
                               "test_channelize_power_stream_puts_its_chunks_on_the_card",
    **dict.fromkeys(["Metrics", "ThroughputMeter", "log_event"], "host counters and logs"),
    **dict.fromkeys(["BenchResult", "benchmark", "hard_sync", "slope_rate", "timed_median",
                     "trace"], "times the caller's function where it runs"),
    "device_hbm_bandwidth": "a data-sheet rate of a CUDA card, None the current one "
                            "(test_torch_utils.py)",
    **dict.fromkeys(
        ["PrefetchingWavReader", "RingBuffer", "WavReader", "read_wav", "stream_wav",
         "write_wav", "PrefetchingRawReader", "RawStreamReader", "read_iq", "read_raw",
         "write_iq", "write_raw", "load_state", "save_state"],
        "file IO: host arrays in and out"),
}

REGISTERED = {name for names in registry.FUNCTION_TYPES.values() for name in names}


def _registered_name(key):
    """The registered function a table's key stands for: the key, the class
    of a 'Class.method' key, or the longest registered name the key extends
    with '_' ('framed_dft_dense' is a second case of framed_dft); None for a
    name outside the registry (the models' pipelines)."""
    head = key.split(".")[0]
    if head in REGISTERED:
        return head
    longer = [name for name in REGISTERED if head.startswith(name + "_")]
    return max(longer, key=len) if longer else None


def test_every_registered_function_has_one_place():
    """Every function of the registry is in exactly one of ENTRY_POINTS (it
    takes a signal), NO_SIGNAL or NO_TENSOR (it takes none), HOST_NUMPY or
    EXEMPT, so a new public function cannot escape the rule. A function
    with both forms (a simulation with or without times, a CZT plan called
    or asked for its points) is an entry point; its other form is a
    NO_SIGNAL or NO_TENSOR case."""
    places = {"ENTRY_POINTS": ENTRY_POINTS, "NO_SIGNAL or NO_TENSOR": {**NO_SIGNAL, **NO_TENSOR},
              "HOST_NUMPY": HOST_NUMPY, "EXEMPT": EXEMPT}
    covered = {place: {_registered_name(key) for key in table}
               for place, table in places.items()}
    wrong = {}
    for name in sorted(REGISTERED):
        found = [place for place, names in covered.items() if name in names]
        if "ENTRY_POINTS" in found and "NO_SIGNAL or NO_TENSOR" in found:
            found.remove("NO_SIGNAL or NO_TENSOR")
        if len(found) != 1:
            wrong[name] = found
    assert not wrong, wrong
    assert set(HOST_NUMPY) | set(EXEMPT) <= REGISTERED
