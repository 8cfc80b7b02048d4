"""nx_signal_tpu_torch — the PyTorch/CUDA port of nx_signal_tpu.

The JAX package `nx_signal_tpu` is the reference; this package keeps its
module layout and function names so each counterpart is found by path, and
its layouts at the public functions: (..., L) signals and (..., frames, bins)
spectra. It imports torch and numpy only, never jax.

Layering:
  ops/       windows, waveforms (sinc), filters (firwin)
  spectral/  framing (as_windowed / overlap_and_add), stft / istft
  kernels/   host weight functions and plain paths (dft.py), hand-written
             CUDA kernels for Hopper (csrc/, bound in cuda_dft.py)
  models/    the STFT+FIR chain (stft_fir_chain, StftFirChain)

On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor inside a kernel's contract the kernel runs, or the call raises.
"""

from nx_signal_tpu_torch.models.pipeline import StftFirChain, stft_fir_chain
from nx_signal_tpu_torch.ops.filters import firwin
from nx_signal_tpu_torch.ops.windows import get_window, hamming, hann
from nx_signal_tpu_torch.spectral.framing import as_windowed, overlap_and_add
from nx_signal_tpu_torch.spectral.stft import STFTResult, fft_frequencies, istft, stft

__all__ = [
    "StftFirChain",
    "stft_fir_chain",
    "firwin",
    "get_window",
    "hamming",
    "hann",
    "as_windowed",
    "overlap_and_add",
    "STFTResult",
    "fft_frequencies",
    "istft",
    "stft",
]
