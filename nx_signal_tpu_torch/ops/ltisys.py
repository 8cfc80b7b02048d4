"""Continuous-time systems (counterpart of nx_signal_tpu/ops/ltisys.py).

Only `findfreqs` so far, the frequency grid of `ops.filters.freqs` and
`freqs_zpk`; the rest of the module comes with the IIR design math.
"""

import numpy as np

__all__ = ["findfreqs"]


def findfreqs(num, den, n: int, kind: str = "ba"):
    """Log-spaced frequency grid over a system's interesting range,
    scipy.signal.findfreqs semantics (f64 numpy on the host).

    Examples:

    >>> from nx_signal_tpu_torch.ops.ltisys import findfreqs
    >>> findfreqs([1.0], [1.0, 1.0], 4).round(4)
    array([ 0.01,  0.1 ,  1.  , 10.  ])
    """
    if kind == "ba":
        ep = np.atleast_1d(np.roots(np.atleast_1d(den))) + 0j
        tz = np.atleast_1d(np.roots(np.atleast_1d(num))) + 0j
    elif kind == "zp":
        ep = np.atleast_1d(den) + 0j
        tz = np.atleast_1d(num) + 0j
    else:
        raise ValueError("input must be one of {'ba', 'zp'}")
    if len(ep) == 0:
        ep = np.atleast_1d(-1000.0) + 0j
    ez = np.r_[ep[ep.imag >= 0], tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)]]
    integ = (np.abs(ez) < 1e-10).astype(float)
    hfreq = np.round(np.log10(np.max(3.0 * np.abs(ez.real + integ) + 1.5 * ez.imag)) + 0.5)
    lfreq = np.round(np.log10(0.1 * np.min(np.abs((ez + integ).real) + 2.0 * ez.imag)) - 0.5)
    return np.logspace(lfreq, hfreq, n)
