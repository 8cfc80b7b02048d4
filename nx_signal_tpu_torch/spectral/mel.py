"""Mel filterbanks and log-mel spectrograms, Whisper-style (counterpart of
nx_signal_tpu/spectral/mel.py). The mel projection is one exact-f32 matmul
over the frequency axis.
"""

import math

import torch

from nx_signal_tpu_torch.kernels.dft import _exact_f32
from nx_signal_tpu_torch.spectral.stft import _linspace, fft_frequencies
from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.profiling import span

__all__ = ["mel_filters", "stft_to_mel"]


def mel_filters(fft_length: int, mel_bins: int, sampling_rate, *, max_mel: float = 3016.0,
                mel_frequency_spacing: float = 200.0 / 3.0, dtype=DEFAULT_FLOAT,
                device=None):
    """Slaney-style mel filterbank matrix [mels, frequencies]: linear
    spacing below the 1 kHz breakpoint, log spacing (step log(6.4)/27)
    above, triangular weights with the Slaney 2/bandwidth normalization,
    computed on `device` (None: the card).

    Examples:

    >>> from nx_signal_tpu_torch.spectral.mel import mel_filters
    >>> fb = mel_filters(16, 3, 8000.0, device="cpu")
    >>> fb.shape
    torch.Size([3, 16])
    >>> fb[:, :6].numpy().round(4)
    array([[0.    , 0.0008, 0.0009, 0.0002, 0.    , 0.    ],
           [0.    , 0.    , 0.0002, 0.0005, 0.0006, 0.0004],
           [0.    , 0.    , 0.    , 0.    , 0.    , 0.0001]], dtype=float32)
    """
    device = target_device(device)
    f_sp = mel_frequency_spacing
    fftfreqs = fft_frequencies(sampling_rate, fft_length=fft_length, dtype=dtype,
                               device=device)
    mels = _linspace(0.0, max_mel / f_sp, mel_bins + 2, dtype=dtype, device=device)
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    mel_f = torch.where(mels >= min_log_mel,
                        min_log_hz * torch.exp(logstep * (mels - min_log_mel)), freqs)
    fdiff = (mel_f[1:] - mel_f[:-1])[:, None]
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:mel_bins] / fdiff[:mel_bins]
    upper = ramps[2:mel_bins + 2] / fdiff[1:mel_bins + 1]
    tri = torch.minimum(lower, upper)
    weights = torch.where(tri > 0.0, tri, torch.zeros_like(tri))  # +0.0, never -0.0
    enorm = 2.0 / (mel_f[2:mel_bins + 2] - mel_f[:mel_bins])
    return (weights * enorm[:, None]).to(dtype)


def _slaney_max_mel(hz: float) -> float:
    """The `max_mel` of `mel_filters` (at its default spacing, 200/3) whose
    top edge is `hz`: the Slaney mel of `hz` (librosa's hz_to_mel, htk=False)
    times the spacing. At 8 kHz it is 3016.376..., where the default 3016.0
    puts the edge at 7996.9 Hz."""
    min_log_hz = 1000.0
    if hz < min_log_hz:
        return hz
    return min_log_hz + 200.0 / 3.0 * math.log(hz / min_log_hz) / (math.log(6.4) / 27.0)


def _log_mel(power, filters, freq_size: int, *, clips: bool = False):
    """Mel projection of the first `freq_size` bins, log10 with a 1e-10
    clip, the dynamic-range floor max(log, max(log) - 8), then (x + 4)/4.

    The (..., frames, bins) power gives (..., frames, mels), floored at the
    max of the whole batch. With `clips` it is a batch of independent clips,
    as Whisper's encoder takes them: it gives (..., mels, frames),
    contiguous (the product taken as filters @ power^T, so that no
    transpose is copied), each clip floored at the max of its own mels and
    frames; a (frames, bins) power is one clip."""
    with span("nx.mel"):
        with _exact_f32():
            if clips:
                frames, bins = power.shape[-2:]
                flat = power.reshape(-1, frames, bins)[..., :freq_size].transpose(-1, -2)
                weights = filters[:, :freq_size].expand(flat.shape[0], -1, -1)
                mel_spec = torch.bmm(weights, flat).reshape(
                    *power.shape[:-2], filters.shape[0], frames)
            else:
                mel_spec = torch.matmul(power[..., :freq_size], filters[:, :freq_size].T)
        log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
        top = log_spec.amax(dim=(-2, -1), keepdim=True) if clips else log_spec.max()
        log_spec = torch.maximum(log_spec, top - 8.0)
        return (log_spec + 4.0) / 4.0


def stft_to_mel(z, sampling_rate, *, fft_length: int, mel_bins: int = 128,
                max_mel: float = 3016.0, mel_frequency_spacing: float = 200.0 / 3.0,
                dtype=DEFAULT_FLOAT):
    """STFT spectrum -> log-mel spectrogram with Whisper's normalization:
    |z|^2 on the first fft_length//2 bins, mel projection, log10 with a
    1e-10 clip, dynamic-range floor max(log, max(log) - 8), then (x + 4)/4.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.spectral.mel import stft_to_mel
    >>> from nx_signal_tpu_torch.spectral.stft import stft
    >>> x = torch.sin(0.3 * torch.arange(4000.0))
    >>> z, t, f = stft(x, hann(256, device="cpu"), sampling_rate=8000.0, fft_length=256,
    ...                overlap_length=128, onesided=True)
    >>> m = stft_to_mel(z, 8000.0, fft_length=256, mel_bins=40)
    >>> m.shape, bool(torch.isfinite(m).all())
    (torch.Size([30, 40]), True)
    """
    z = as_signal(z)
    filters = mel_filters(fft_length, mel_bins, sampling_rate, max_mel=max_mel,
                          mel_frequency_spacing=mel_frequency_spacing, dtype=dtype,
                          device=z.device)
    return _log_mel(z.abs().to(dtype) ** 2, filters, fft_length // 2)
