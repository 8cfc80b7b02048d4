"""nx_signal_tpu_torch — the PyTorch/CUDA port of nx_signal_tpu.

The JAX package `nx_signal_tpu` is the reference; this package keeps its
module layout and function names so each counterpart is found by path, and
its layouts at the public functions: (..., L) signals and (..., frames, bins)
spectra. It imports torch and numpy only, never jax.

Layering:
  ops/       windows (every get_window name), waveforms (sinc), filters
             (firwin, firwin_2d, median, wiener, medfilt, order_filter,
             savgol, detrend, the frequency responses, gammatone,
             max_len_seq), ltisys (findfreqs), convolution (convolve,
             correlate, fftconvolve, oaconvolve, convolve2d, ...),
             transforms (the N-D FFT helpers)
  spectral/  framing (as_windowed / overlap_and_add), stft / istft,
             check_cola / check_nola, mel (mel_filters, stft_to_mel),
             spectrogram, estimation (welch, csd, periodogram, coherence,
             lombscargle, vectorstrength), short_time_fft (ShortTimeFFT,
             closest_STFT_dual_window)
  kernels/   host weight functions and plain paths (dft.py), hand-written
             CUDA kernels for Hopper (csrc/, bound in cuda_dft.py and
             cuda_halo.py)
  models/    the pipelines (stft_fir_chain, StftFirChain, FIRFilterChain,
             SpectrogramPipeline, LogMelFrontend)
  parallel/  mesh (make_dsp_mesh) and sharded (sharded_convolve_same,
             sharded_fir_framed_dft_power, sharded_stft, sharded_istft,
             sharded_oaconvolve_same, gather_blocks) and estimation
             (sharded_welch, sharded_csd, sharded_coherence) on
             torch.distributed, one process per rank

On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor inside a kernel's contract the kernel runs, or the call raises.
The entry points run on the card unless asked for the CPU: a signal that
is not a tensor goes to the CUDA device (utils/devices.py).
"""

from nx_signal_tpu_torch.kernels.dft import fir_framed_dft, fir_framed_dft_shared
from nx_signal_tpu_torch.models.pipeline import (
    FIRFilterChain,
    LogMelFrontend,
    SpectrogramPipeline,
    StftFirChain,
    stft_fir_chain,
)
from nx_signal_tpu_torch.ops.convolution import (
    convolve,
    convolve2d,
    correlate,
    correlate2d,
    fftconvolve,
    oaconvolve,
)
from nx_signal_tpu_torch.ops.filters import (
    detrend,
    firwin,
    firwin_2d,
    freqs,
    freqs_zpk,
    freqz,
    freqz_sos,
    freqz_zpk,
    gammatone,
    group_delay,
    max_len_seq,
    medfilt,
    medfilt2d,
    median,
    order_filter,
    savgol_coeffs,
    savgol_filter,
    sosfreqz,
    wiener,
)
from nx_signal_tpu_torch.ops.windows import get_window, hamming, hann, kaiser
from nx_signal_tpu_torch.parallel.estimation import (
    sharded_coherence,
    sharded_csd,
    sharded_welch,
)
from nx_signal_tpu_torch.spectral.estimation import (
    coherence,
    csd,
    lombscargle,
    periodogram,
    vectorstrength,
    welch,
)
from nx_signal_tpu_torch.spectral.framing import as_windowed, overlap_and_add
from nx_signal_tpu_torch.spectral.mel import mel_filters, stft_to_mel
from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT, closest_STFT_dual_window
from nx_signal_tpu_torch.spectral.spectrogram import spectrogram
from nx_signal_tpu_torch.spectral.stft import (
    STFTResult,
    check_cola,
    check_nola,
    fft_frequencies,
    istft,
    stft,
)

__all__ = [
    "fir_framed_dft",
    "fir_framed_dft_shared",
    "FIRFilterChain",
    "LogMelFrontend",
    "SpectrogramPipeline",
    "StftFirChain",
    "stft_fir_chain",
    "convolve",
    "convolve2d",
    "correlate",
    "correlate2d",
    "fftconvolve",
    "oaconvolve",
    "detrend",
    "firwin",
    "firwin_2d",
    "freqs",
    "freqs_zpk",
    "freqz",
    "freqz_sos",
    "freqz_zpk",
    "gammatone",
    "group_delay",
    "max_len_seq",
    "medfilt",
    "medfilt2d",
    "median",
    "order_filter",
    "savgol_coeffs",
    "savgol_filter",
    "sosfreqz",
    "wiener",
    "get_window",
    "hamming",
    "hann",
    "kaiser",
    "sharded_coherence",
    "sharded_csd",
    "sharded_welch",
    "coherence",
    "csd",
    "lombscargle",
    "periodogram",
    "vectorstrength",
    "welch",
    "as_windowed",
    "overlap_and_add",
    "mel_filters",
    "stft_to_mel",
    "ShortTimeFFT",
    "closest_STFT_dual_window",
    "spectrogram",
    "STFTResult",
    "check_cola",
    "check_nola",
    "fft_frequencies",
    "istft",
    "stft",
]
