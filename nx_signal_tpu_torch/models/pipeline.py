"""The STFT+FIR chain (counterpart of nx_signal_tpu/models/pipeline.py):
a FIR low-pass followed by a windowed STFT power spectrogram, fused into one
frame contraction against weights that fold the filter's 'same' Toeplitz
matrix into the window-scaled DFT (kernels/dft.py:fir_framed_dft). On a
CUDA tensor the contraction is the hand-written kernel A
(kernels/cuda_dft.py:fir_framed_dft_power_cuda)."""

import numpy as np
import torch
from torch import nn

from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_cuda
from nx_signal_tpu_torch.kernels.dft import (
    _same_pad_left,
    fir_dft_fold_weights,
    fir_framed_dft,
    good_matmul_fft_length,
)

__all__ = ["StftFirChain", "stft_fir_chain"]


def stft_fir_chain(x, taps, window, *, fft_length: int, overlap_length: int,
                   sampling_rate: float = 16000.0, fir_method: str = "direct",
                   onesided: bool = True, return_filtered: bool = True,
                   precision: str = "highest", frame_chunks=1):
    """FIR filter then windowed STFT power spectrogram of the (..., L)
    signal: returns the (..., frames, bins) power of the 'same'-filtered
    signal with 'valid' framing at hop frame_length - overlap_length.

    Only the fused path is ported: `return_filtered=False` with real input
    and frame_length <= fft_length <= 1024, which runs
    `kernels.dft.fir_framed_dft(output='power')` and never builds the
    filtered signal. The filtered signal itself (`return_filtered=True`) and
    the other paths need ops/convolution.py, which is not ported yet, and
    raise NotImplementedError. `fir_method` and `sampling_rate` only matter
    on those paths.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import stft_fir_chain
    >>> from nx_signal_tpu_torch.ops.filters import firwin
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> x = torch.randn(2, 4096, generator=torch.Generator().manual_seed(0))
    >>> p = stft_fir_chain(x, firwin(31, [2000.0], sampling_rate=16000.0), hann(256),
    ...                    fft_length=256, overlap_length=192, return_filtered=False)
    >>> p.shape
    torch.Size([2, 61, 129])
    """
    x = torch.as_tensor(x)
    n_fft = fft_length
    frame_length = np.shape(window)[-1]
    stride = frame_length - overlap_length
    matmul_ok = (not x.is_complex() and good_matmul_fft_length(n_fft)
                 and n_fft >= frame_length)
    if return_filtered or not matmul_ok:
        raise NotImplementedError(
            "stft_fir_chain: only return_filtered=False with real input and "
            "frame_length <= fft_length <= 1024 is ported; the other paths need "
            "ops/convolution.py (ROADMAP queue 1 item 6)")
    return fir_framed_dft(x, taps, window, stride=stride, n_fft=n_fft,
                          onesided=onesided, precision=precision, output="power",
                          frame_chunks=frame_chunks)


class StftFirChain(nn.Module):
    """The fused STFT+FIR power chain as a module: the folded (frame + K - 1,
    2*bins) f32 weights, T(taps) @ diag(window) @ DFT built once on the host
    in f64, are its `weights` buffer (so `.to(device)` moves them), and
    `forward(x)` maps the real (..., L) signal to its one-sided
    (..., frames, bins) power spectrogram, equal to
    `stft_fir_chain(x, taps, window, ..., return_filtered=False)`. On a CUDA
    tensor forward runs kernel A; on a CPU tensor its plain version.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import StftFirChain
    >>> from nx_signal_tpu_torch.ops.filters import firwin
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> chain = StftFirChain.from_numpy(firwin(31, [0.2]).numpy(), hann(256).numpy(),
    ...                                 stride=64, n_fft=256)
    >>> chain(torch.zeros(3, 1024)).shape
    torch.Size([3, 13, 129])
    """

    def __init__(self, weights, *, stride: int, num_taps: int, frame_length: int,
                 n_fft: int):
        super().__init__()
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if tuple(weights.shape) != (frame_length + num_taps - 1, 2 * (n_fft // 2 + 1)):
            raise ValueError(f"weights of shape {tuple(weights.shape)} do not fold "
                             f"{num_taps} taps into a {frame_length}-frame, {n_fft}-point DFT")
        self.register_buffer("weights", weights)
        self.stride = stride
        self.frame_length = frame_length
        self.pad_left = _same_pad_left(num_taps)
        self.bins = n_fft // 2 + 1

    @classmethod
    def from_numpy(cls, taps, window, *, stride: int, n_fft: int, device=None):
        """Fold the numpy `taps` and `window` (e.g. `np.asarray` of the JAX
        package's firwin / hann) into the module's weights on `device`."""
        taps = np.asarray(taps, dtype=np.float64).reshape(-1)
        window = np.asarray(window, dtype=np.float64)
        if n_fft < window.shape[-1]:
            raise ValueError(f"n_fft {n_fft} is shorter than the window {window.shape[-1]}")
        weights = fir_dft_fold_weights(taps, window, n_fft, True, device=device)
        return cls(weights, stride=stride, num_taps=taps.shape[0],
                   frame_length=window.shape[-1], n_fft=n_fft)

    def forward(self, x):
        if x.is_complex():
            raise ValueError("StftFirChain needs a real signal")
        if x.shape[-1] < self.frame_length:
            raise ValueError(f"window length {self.frame_length} exceeds signal "
                             f"length {x.shape[-1]}")
        num_frames = (x.shape[-1] - self.frame_length) // self.stride + 1
        return fir_framed_dft_power_cuda(x, self.weights, stride=self.stride,
                                         pad_left=self.pad_left, num_frames=num_frames,
                                         bins=self.bins)
