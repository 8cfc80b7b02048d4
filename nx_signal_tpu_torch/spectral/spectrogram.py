"""scipy.signal.spectrogram-style wrapper over the STFT (counterpart of
nx_signal_tpu/spectral/spectrogram.py): (f, t, Sxx) from `spectral.stft`,
so a real signal with fft_length <= 1024 runs kernel B-fft on the card.
"""

import torch

from nx_signal_tpu_torch.ops.windows import get_window
from nx_signal_tpu_torch.spectral.stft import stft
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["spectrogram"]


def spectrogram(x, sampling_rate, *, window="hann", window_length: int = 256,
                overlap_length: int = None, fft_length=None, mode: str = "psd",
                onesided: bool = True):
    """Spectrogram of the (..., L) signal: (frequencies, times, Sxx) with Sxx
    of shape (..., frequencies, frames), scipy.signal.spectrogram's layout.

    `window` is a get_window spec, taken periodic (DFT-even);
    `overlap_length` defaults to window_length // 8 (scipy's default);
    `mode` is 'psd' (|z|^2 / (Fs sum(w^2)), the one-sided bins doubled but
    DC and Nyquist), 'magnitude' (|z|) or 'complex' (the STFT).

    Examples:

    A 1 kHz tone sampled at 8 kHz peaks in the 1 kHz bin:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.spectrogram import spectrogram
    >>> x = torch.sin(2 * torch.pi * 1000.0 * torch.arange(2048) / 8000.0)
    >>> f, t, S = spectrogram(x, 8000.0, window_length=256)
    >>> tuple(S.shape), float(f[S.mean(dim=-1).argmax()])
    ((129, 9), 1000.0)
    """
    if mode not in ("psd", "magnitude", "complex"):
        raise ValueError(f"mode must be one of 'psd', 'magnitude', 'complex', got: {mode}")
    x = as_signal(x)
    if overlap_length is None:
        overlap_length = window_length // 8
    w = get_window(window, window_length, periodic=True, dtype=DEFAULT_FLOAT, device=x.device)
    n_fft = fft_length if fft_length is not None else window_length
    z, times, freqs = stft(x, w, sampling_rate=sampling_rate, fft_length=n_fft,
                           overlap_length=overlap_length, onesided=onesided)
    if mode == "complex":
        out = z
    elif mode == "magnitude":
        # NaN wherever a part is NaN, as jnp.abs gives it (torch's complex
        # abs is inf for an inf part beside a NaN one)
        out = torch.where(torch.isnan(z.real) | torch.isnan(z.imag), torch.nan, z.abs())
    else:
        scale = 1.0 / (sampling_rate * torch.sum(w.to(DEFAULT_FLOAT) ** 2))
        out = (z.real ** 2 + z.imag ** 2) * scale
        if onesided:
            # the redundant conjugate half's power folded into the kept bins
            doubling = torch.full((out.shape[-1],), 2.0, dtype=DEFAULT_FLOAT, device=x.device)
            doubling[0] = 1.0
            if n_fft % 2 == 0:
                doubling[-1] = 1.0
            out = out * doubling
    return freqs, times, out.transpose(-1, -2)
