"""Window functions (counterpart of nx_signal_tpu/ops/windows.py).

The cosine-sum windows hann, hamming and blackman (computed in the
requested dtype, as the JAX package computes them) and the host-built
general_cosine family, each with the periodic (DFT-even, default) vs
symmetric (filter-design) distinction: the periodic window of length n is
the symmetric window of length n + 1 without its last sample.
"""

import math

import numpy as np
import torch

from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["blackman", "hamming", "hann", "general_cosine", "get_window"]


def _cosine_window(n: int, coefs, periodic: bool, dtype, device):
    """General cosine-sum window: sum_k (-1)^k a_k cos(2 pi k i / (L-1))."""
    if n == 1:
        return torch.ones((1,), dtype=dtype, device=device)  # scipy convention
    length = n + 1 if periodic else n
    cdt = dtype if dtype.is_floating_point else torch.float32
    i = torch.arange(length, dtype=cdt, device=device)
    theta = 2.0 * math.pi * i / (length - 1)
    w = torch.zeros((length,), dtype=cdt, device=device)
    for k, a in enumerate(coefs):
        sign = 1.0 if k % 2 == 0 else -1.0
        w = w + sign * a * torch.cos(k * theta)
    w = w.to(dtype)
    return w[:n] if periodic else w


def blackman(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Blackman window 0.42 - 0.5 cos + 0.08 cos(2·).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import blackman
    >>> blackman(8, periodic=False).numpy().round(4)
    array([-0.    ,  0.0905,  0.4592,  0.9204,  0.9204,  0.4592,  0.0905,
           -0.    ], dtype=float32)
    """
    return _cosine_window(n, (0.42, 0.5, 0.08), periodic, dtype, device)


def hamming(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Hamming window 0.54 - 0.46 cos.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import hamming
    >>> hamming(6, periodic=False).numpy().round(4)
    array([0.08  , 0.3979, 0.9121, 0.9121, 0.3979, 0.08  ], dtype=float32)
    """
    return _cosine_window(n, (0.54, 0.46), periodic, dtype, device)


def hann(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Hann window 0.5 (1 - cos).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> hann(4)
    tensor([0.0000, 0.5000, 1.0000, 0.5000])
    """
    return _cosine_window(n, (0.5, 0.5), periodic, dtype, device)


def _host_window(n: int, periodic: bool, dtype, device, build):
    """Symmetric->periodic plumbing for windows built in f64 numpy."""
    if n == 0:
        return torch.zeros((0,), dtype=dtype, device=device)
    if n == 1:
        return torch.ones((1,), dtype=dtype, device=device)  # scipy convention
    length = n + 1 if periodic else n
    w = np.asarray(build(length), dtype=np.float64)
    return torch.as_tensor(w[:n], device=device).to(dtype)


def general_cosine(n: int, coefs, *, periodic: bool = True, dtype=DEFAULT_FLOAT,
                   device=None):
    """Weighted cosine-sum window sum_k a_k cos(k th), th in [-pi, pi]
    (scipy.signal.windows.general_cosine semantics), built in f64.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import general_cosine
    >>> general_cosine(6, [0.6, 0.4], periodic=False).numpy().round(4)
    array([0.2   , 0.4764, 0.9236, 0.9236, 0.4764, 0.2   ], dtype=float32)
    """
    def build(length):
        fac = np.linspace(-np.pi, np.pi, length)
        w = np.zeros(length)
        for k, a in enumerate(coefs):
            w += a * np.cos(k * fac)
        return w
    return _host_window(n, periodic, dtype, device, build)


_COSINE_WINDOWS = {
    "blackman": blackman,
    "hamming": hamming,
    "hann": hann,
}


def get_window(window, n: int, *, periodic: bool = False, dtype=DEFAULT_FLOAT,
               device=None):
    """Build a window from a name ('hann', 'hamming', 'blackman') or a
    ('general_cosine', coefs) tuple; symmetric by default, as filter design
    requires. The other windows of the JAX package are not ported yet.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import get_window
    >>> get_window("hann", 4).numpy().round(4)
    array([0.  , 0.75, 0.75, 0.  ], dtype=float32)
    """
    if isinstance(window, (tuple, list)) and window and window[0] == "general_cosine":
        _, coefs = window
        return general_cosine(n, coefs, periodic=periodic, dtype=dtype, device=device)
    if isinstance(window, str) and window in _COSINE_WINDOWS:
        return _COSINE_WINDOWS[window](n, periodic=periodic, dtype=dtype, device=device)
    raise ValueError(
        f"unknown or not yet ported window {window!r}, supported: "
        f"{sorted(_COSINE_WINDOWS)} or ('general_cosine', coefs)"
    )
