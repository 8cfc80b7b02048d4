"""FIR filter design (counterpart of nx_signal_tpu/ops/filters.py): only
`firwin` so far, in the JAX package's float32 arithmetic. median and wiener
are not ported yet."""

import math

import torch

from nx_signal_tpu_torch.ops.waveforms import sinc
from nx_signal_tpu_torch.ops.windows import get_window
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["firwin"]


def firwin(num_taps: int, cutoff, *, window="hamming", pass_zero: bool = True,
           scale: bool = True, sampling_rate: float = 2.0, dtype=DEFAULT_FLOAT,
           device=None):
    """FIR filter design by the window method (scipy.signal.firwin
    semantics). Cutoffs are in the units of `sampling_rate` (default 2.0,
    i.e. normalized with 1 = Nyquist), strictly inside (0, Nyquist). The
    window is symmetric, as filter design requires.

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import firwin
    >>> firwin(5, [0.5]).numpy().round(4)
    array([-0.    ,  0.2037,  0.5926,  0.2037, -0.    ], dtype=float32)
    """
    if isinstance(cutoff, (int, float)):
        cutoff = [cutoff]
    cutoff = list(cutoff)
    if not cutoff:
        raise ValueError(f"cutoff must be a non-empty list of frequencies, got: {cutoff}")
    nyq = sampling_rate / 2.0
    cutoffs = sorted(c / nyq for c in cutoff)
    if cutoffs[0] <= 0.0 or cutoffs[-1] >= 1.0:
        bad = cutoffs[0] if cutoffs[0] <= 0.0 else cutoffs[-1]
        raise ValueError(
            "cutoff must be strictly between 0 and Nyquist (exclusive), got: "
            f"{bad * nyq}"
        )

    even_n_cuts = len(cutoffs) % 2 == 0
    nyquist_gain = (pass_zero and even_n_cuts) or (not pass_zero and not even_n_cuts)
    if nyquist_gain and num_taps % 2 == 0:
        raise ValueError(
            "a filter with non-zero gain at Nyquist (e.g. highpass) requires "
            f"an odd number of taps, got: {num_taps}"
        )

    m = (num_taps - 1) / 2.0
    alpha = torch.arange(num_taps, dtype=dtype, device=device) - m

    # ideal response: sum over the selected passbands of [0 | cutoffs | 1]
    # of b*sinc(b*alpha) - a*sinc(a*alpha)
    bands = [0.0] + cutoffs + [1.0]
    pairs = list(zip(bands[:-1], bands[1:]))
    selected = [p for i, p in enumerate(pairs) if (i % 2 == 0) == pass_zero]
    h = torch.zeros((num_taps,), dtype=dtype, device=device)
    for a, b in selected:
        h = h + b * sinc(b * alpha) - a * sinc(a * alpha)

    h = h * get_window(window, num_taps, periodic=False, dtype=dtype, device=device)

    if scale:
        # unit response at DC (pass_zero), Nyquist (single-cutoff highpass)
        # or the first passband's center
        if pass_zero:
            scale_freq = 0.0
        elif len(cutoffs) == 1:
            scale_freq = 1.0
        else:
            scale_freq = (cutoffs[0] + cutoffs[1]) / 2.0
        factor = torch.abs(torch.dot(h, torch.cos(alpha * (math.pi * scale_freq))))
        h = h / factor
    return h
