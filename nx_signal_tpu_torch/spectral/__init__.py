"""Spectral analysis of the port (counterpart of nx_signal_tpu/spectral):
the names the JAX subpackage re-exports, each from its port module. As
there, the functions `stft` and `spectrogram` shadow the submodules of the
same name on the package; reach a submodule with importlib.import_module.
"""

from nx_signal_tpu_torch.spectral.estimation import coherence, csd, periodogram, welch
from nx_signal_tpu_torch.spectral.framing import as_windowed, overlap_and_add
from nx_signal_tpu_torch.spectral.mel import mel_filters, stft_to_mel
from nx_signal_tpu_torch.spectral.spectrogram import spectrogram
from nx_signal_tpu_torch.spectral.stft import STFTResult, fft_frequencies, istft, stft

__all__ = [
    "as_windowed",
    "overlap_and_add",
    "mel_filters",
    "spectrogram",
    "stft_to_mel",
    "STFTResult",
    "fft_frequencies",
    "istft",
    "stft",
    "periodogram",
    "welch",
    "csd",
    "coherence",
]
