"""LTI systems (counterpart of nx_signal_tpu/ops/ltisys.py).

So far `findfreqs`, the frequency grid of `ops.filters.freqs` and
`freqs_zpk`, and `normalize` (with its `BadCoefficients` warning), which
the IIR design math needs. Host-side f64 numpy, as in the JAX package.
"""

import warnings

import numpy as np

__all__ = ["BadCoefficients", "normalize", "findfreqs"]


class BadCoefficients(UserWarning):
    """Warning emitted when a transfer function's numerator carries
    leading near-zero coefficients that get trimmed — scipy.signal
    BadCoefficients semantics (the trimmed filter may be meaningless if
    the zeros were not intentional).

    Examples:

    >>> import warnings
    >>> from nx_signal_tpu_torch.ops.ltisys import BadCoefficients, normalize
    >>> with warnings.catch_warnings(record=True) as rec:
    ...     warnings.simplefilter("always")
    ...     _ = normalize([0.0, 3.0, 6.0], [2.0, 4.0])
    >>> rec[0].category is BadCoefficients
    True
    """


def normalize(b, a):
    """Normalize a transfer function to a[0] == 1, trimming leading-zero
    numerator coefficients — scipy.signal.normalize semantics (b may be
    2-D for multi-output).

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.ltisys import normalize
    >>> b, a = normalize([2.0, 4.0], [2.0, 1.0])
    >>> np.round(b, 4), np.round(a, 4)
    (array([1., 2.]), array([1. , 0.5]))
    """
    b = np.atleast_1d(np.asarray(b, dtype=np.float64)) + 0j \
        if np.iscomplexobj(b) else np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=b.dtype))
    if a.ndim != 1:
        raise ValueError("Denominator polynomial must be rank-1 array.")
    if b.ndim > 2:
        raise ValueError("Numerator polynomial must be rank-1 or rank-2 array.")
    if np.all(a == 0):
        raise ValueError("Denominator must have at least one nonzero element.")
    b2 = np.atleast_2d(b)
    if b2.shape[-1] > a.shape[0]:
        leading = b2[:, : b2.shape[-1] - a.shape[0]]
        if not np.allclose(leading, 0, atol=1e-14):
            raise ValueError("Improper transfer function. "
                             "`num` is longer than `den`.")
        b2 = b2[:, b2.shape[-1] - a.shape[0]:]
        # scipy warns whenever leading zeros are dropped, including the
        # improper-length case above
        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", BadCoefficients)
    # strip leading zero columns shared by every row (keep at least 1);
    # scipy's threshold is atol=1e-14 — a genuinely small leading
    # coefficient (e.g. 1e-10) must be KEPT, not trimmed
    if b2.shape[-1] > 1 and np.allclose(b2[:, 0], 0, atol=1e-14):
        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", BadCoefficients)
        while b2.shape[-1] > 1 and np.allclose(b2[:, 0], 0, atol=1e-14):
            b2 = b2[:, 1:]
    a0 = a[0]
    out_b = b2 / a0
    out_a = a / a0
    if b.ndim == 1:
        out_b = out_b[0]
    return out_b, out_a


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
