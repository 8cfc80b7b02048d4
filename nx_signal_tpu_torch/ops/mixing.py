"""Frequency translation (mixing) and complex baseband conversion
(counterpart of nx_signal_tpu/ops/mixing.py): mix a band down to complex
baseband, low-pass with `firwin`, decimate with `resample_poly`.

The local oscillator's phase is the JAX package's float32 argument,
-2*pi*(fc/fs) * n - phase with n a float32 sample index, so on long
signals it drifts from the float64 oscillator exactly as the reference
does (ROADMAP.md, queue 3, "the mixer's f32 phase").
"""

import math

import torch

from nx_signal_tpu_torch.ops.filters import firwin
from nx_signal_tpu_torch.ops.resample import resample_poly
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["mix_down", "demodulate_channel"]


def mix_down(x, carrier_frequency, sampling_rate, *, phase: float = 0.0):
    """Multiply by exp(-2*pi*i*fc*t): shift the band at `carrier_frequency`
    down to DC (complex baseband). Operates along the last axis; sample
    times are n / sampling_rate. The oscillator's argument is float32 (the
    Python scalar -2*pi*(fc/fs) times a float32 index, minus `phase`), its
    exponential complex64.

    Examples:

    Mixing a quarter-rate cosine down by its own carrier leaves DC (0.5)
    plus the -2fc image alternating on top of it:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.mixing import mix_down
    >>> y = mix_down(torch.cos(2 * torch.pi * 0.25 * torch.arange(8.0)), 0.25, 1.0)
    >>> y.real.numpy().round(4), y.dtype
    (array([1., 0., 1., 0., 1., 0., 1., 0.], dtype=float32), torch.complex64)
    """
    x = as_signal(x)
    n = torch.arange(x.shape[-1], dtype=DEFAULT_FLOAT, device=x.device)
    lo_phase = -2.0 * math.pi * (carrier_frequency / sampling_rate) * n - phase
    lo = torch.exp(1j * lo_phase.to(DEFAULT_FLOAT))
    return x * lo


def demodulate_channel(x, carrier_frequency, sampling_rate, *, bandwidth,
                       decimation: int, num_taps: int = 129):
    """Digital down-converter: mix to baseband, FIR low-pass at
    `bandwidth`/2, decimate by `decimation` (polyphase). Returns the complex
    baseband stream at sampling_rate / decimation.

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.mixing import demodulate_channel
    >>> fs = 8000.0
    >>> x = torch.from_numpy(np.cos(2 * np.pi * 1000 * np.arange(4096) / fs).astype(np.float32))
    >>> base = demodulate_channel(x, 1000.0, fs, bandwidth=200.0, decimation=4)
    >>> base.shape, base.dtype    # complex baseband at fs/4
    (torch.Size([1024]), torch.complex64)
    >>> round(float(base[200:-200].abs().mean()), 2)  # tone -> DC, |.| = 1/2
    0.5
    """
    if decimation < 1:
        raise ValueError(f"decimation must be >= 1, got: {decimation}")
    baseband = mix_down(x, carrier_frequency, sampling_rate)
    # host taps: resample_poly lays out its banded weights on the host
    taps = firwin(num_taps, [bandwidth / 2.0], sampling_rate=sampling_rate, device="cpu")
    return resample_poly(baseband, 1, decimation, taps=taps)
