"""Waveforms (counterpart of nx_signal_tpu/ops/waveforms.py): only `sinc`
so far, which `firwin` needs."""

import math

import torch

from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["sinc"]


def sinc(t):
    """Normalized sinc(t) = sin(pi t) / (pi t) with sinc(0) = 1; integer
    input is promoted to float32.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.waveforms import sinc
    >>> sinc(torch.tensor([0.0, 0.5, 1.0])).numpy().round(4)
    array([ 1.    ,  0.6366, -0.    ], dtype=float32)
    """
    t = torch.as_tensor(t)
    if not (t.dtype.is_floating_point or t.dtype.is_complex):
        t = t.to(DEFAULT_FLOAT)
    x = t * math.pi
    one = torch.ones((), dtype=t.dtype, device=t.device)
    # substitute 1 where x == 0 before dividing, so no NaN is formed
    safe = torch.where(x == 0, one, x)
    return torch.where(x == 0, one, torch.sin(safe) / safe)
