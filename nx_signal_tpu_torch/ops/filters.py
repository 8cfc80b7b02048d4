"""Filters and filter design (counterpart of nx_signal_tpu/ops/filters.py).

* Sliding-window filters on a signal: `median` (the reference's anchored
  window), `wiener` (f64 local moments through `ops.convolution.correlate`),
  `order_filter`, `medfilt`, `medfilt2d`, `savgol_filter` (one FIR through
  `ops.convolution.fir_convolve_1d`, a cuDNN conv1d on the card, and two
  host-built edge matrices) and `detrend`. Each takes its signal through
  `utils.devices.as_signal`.
* Design and analysis on coefficients: `firwin`, `firwin_2d` (float32, as
  the JAX package), `savgol_coeffs`, `max_len_seq`, and the responses
  `freqz`, `sosfreqz`, `freqz_sos`, `freqz_zpk`, `freqs`, `freqs_zpk`,
  `group_delay` in f64 / complex128 (the JAX package's dtype with x64 on).
  Each runs on the device of a coefficient given as a tensor, else on
  `device=`, None the card (`utils.devices.target_device`). `gammatone` is
  host f64 numpy, as the JAX package's.

A median of an even count is the mean of its two middle values, as numpy
and jnp take it (`torch.median` returns the lower one).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.ops.convolution import correlate, fir_convolve_1d
from nx_signal_tpu_torch.ops.waveforms import sinc
from nx_signal_tpu_torch.ops.windows import get_window
from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["median", "medfilt", "medfilt2d", "order_filter", "wiener", "firwin", "firwin_2d",
           "freqz", "sosfreqz", "freqz_sos", "group_delay", "gammatone", "max_len_seq",
           "detrend", "savgol_coeffs", "savgol_filter", "freqz_zpk", "freqs", "freqs_zpk"]


def _median_last(t, dims: int = 1):
    """Median over the last `dims` axes: the middle value of the sorted
    samples, or the mean of the two middle ones for an even count (numpy's
    and jnp's median; `torch.median` returns the lower one, and
    `torch.quantile` refuses more than 2^24 elements). NaN wherever the
    slice holds a NaN, as numpy and jnp give it (`torch.sort` puts NaN
    last, so the middle values alone would hide it).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import _median_last
    >>> _median_last(torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 7.0, 6.0, 0.0]]))
    tensor([2.5000, 5.5000])
    >>> _median_last(torch.tensor([1.0, float("nan"), 3.0]))
    tensor(nan)
    """
    flat = t.reshape(*t.shape[:t.ndim - dims], -1)
    count = flat.shape[-1]
    vals = torch.sort(flat, dim=-1).values
    mid = count // 2
    if count % 2:
        out = vals[..., mid]
    else:
        out = (vals[..., mid - 1] + vals[..., mid]) * 0.5
    last = vals[..., -1]
    return torch.where(torch.isnan(last), last, out)


def median(t, *, kernel_shape):
    """N-D sliding median filter, float32 output, with the reference
    library's window: ANCHORED at each element and extending forward, its
    start clamped so the window fits (windows near the trailing edge shift
    back), unlike scipy.ndimage's centred median.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import median
    >>> median(torch.tensor([1.0, 9.0, 2.0, 8.0, 3.0]), kernel_shape=(3,))
    tensor([2., 8., 3., 3., 3.])
    """
    t = as_signal(t)
    if isinstance(kernel_shape, int):
        kernel_shape = (kernel_shape,)
    if t.ndim != len(kernel_shape):
        raise ValueError("kernel shape must be of the same rank as the tensor")
    rank = t.ndim
    win = t
    for d in range(rank):
        dim, k = t.shape[d], kernel_shape[d]
        starts = torch.clamp(torch.arange(dim, device=t.device), 0, dim - k)
        idx = starts[:, None] + torch.arange(k, device=t.device)[None, :]
        # axis d -> (dim, k), the k window axis moved to the end
        win = win.index_select(d, idx.reshape(-1))
        win = win.reshape(*win.shape[:d], dim, k, *win.shape[d + 1:]).movedim(d + 1, -1)
    return _median_last(win.to(DEFAULT_FLOAT), rank)


def wiener(t, *, kernel_size=3, noise=None):
    """N-D adaptive Wiener filter, scipy.signal.wiener semantics: local mean
    and variance from a correlation with a ones kernel in 'same' mode, in
    f64 (the reference library's precision and the JAX package's with x64
    on); noise defaults to the mean local variance; output l_mean where
    l_var < noise, else l_mean + (t - l_mean)(1 - noise / l_var), cast back
    to the input's dtype.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import wiener
    >>> wiener(torch.tensor([1.0, 2.0, 8.0, 2.0, 1.0]), kernel_size=3).numpy().round(4)
    array([1.    , 2.9922, 5.1556, 2.9922, 1.    ], dtype=float32)
    """
    t = as_signal(t)
    rank = t.ndim
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * rank
    if len(kernel_size) != rank:
        raise ValueError("kernel_size must be an integer or a tuple matching the tensor rank")
    size = math.prod(kernel_size)
    kernel = torch.ones(kernel_size, dtype=torch.float64, device=t.device)
    x = t.to(torch.float64)
    l_mean = correlate(x, kernel, mode="same") / size
    l_var = correlate(x**2, kernel, mode="same") / size - l_mean**2
    noise_t = torch.mean(l_var) if noise is None else torch.as_tensor(
        noise, dtype=torch.float64, device=t.device)
    res = (x - l_mean) * (1.0 - noise_t / l_var)
    return torch.where(l_var < noise_t, l_mean, res + l_mean).to(t.dtype)


def firwin(num_taps: int, cutoff, *, window="hamming", pass_zero: bool = True,
           scale: bool = True, sampling_rate: float = 2.0, dtype=DEFAULT_FLOAT,
           device=None):
    """FIR filter design by the window method (scipy.signal.firwin
    semantics). Cutoffs are in the units of `sampling_rate` (default 2.0,
    i.e. normalized with 1 = Nyquist), strictly inside (0, Nyquist). The
    window is symmetric, as filter design requires.

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import firwin
    >>> firwin(5, [0.5], device="cpu").numpy().round(4)
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

    device = target_device(device)
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


_PASS_ZERO_STRINGS = {"lowpass": True, "bandstop": True, "highpass": False, "bandpass": False}


def _interp(x, xp, fp):
    """numpy.interp of x on the increasing grid xp (ends held)."""
    idx = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[idx - 1], xp[idx], fp[idx - 1], fp[idx]
    out = f0 + (x - x0) * (f1 - f0) / (x1 - x0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], out))


def firwin_2d(hsize, window, *, fc=None, sampling_rate: float = 2.0, circular: bool = False,
              pass_zero=True, scale: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """2-D FIR filter design by the window method, scipy.signal.firwin_2d
    semantics: `circular=False` is the outer product of two 1-D `firwin`
    designs (`window` a 2-list of window specs); `circular=True` samples one
    8x oversampled 1-D prototype radially over the normalized frequency
    grid. `pass_zero` and `scale` reach the 1-D designs, as the JAX
    package's do.

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import firwin_2d
    >>> firwin_2d((3, 3), ("hamming", "hamming"), fc=0.5, device="cpu").numpy().round(4)
    array([[0.0021, 0.0419, 0.0021],
           [0.0419, 0.8237, 0.0419],
           [0.0021, 0.0419, 0.0021]], dtype=float32)
    """
    if len(hsize) != 2:
        raise ValueError("hsize must be a 2-element tuple or list")
    if isinstance(pass_zero, str):
        try:
            pass_zero = _PASS_ZERO_STRINGS[pass_zero]
        except KeyError:
            raise ValueError(
                f"pass_zero must be a bool or one of {sorted(_PASS_ZERO_STRINGS)}, "
                f"got: {pass_zero!r}") from None
    kw = dict(pass_zero=pass_zero, scale=scale, sampling_rate=sampling_rate, dtype=dtype,
              device=device)
    if circular:
        if fc is None:
            raise ValueError("cutoff frequency `fc` must be provided when `circular` is True")
        n_r = max(hsize[0], hsize[1]) * 8  # the oversampled radial prototype
        from nx_signal_tpu_torch.spectral.stft import _linspace

        win_r = firwin(n_r, fc, window=window, **kw)
        # start + i * step, the same bits on every device (torch.linspace
        # rounds some points differently on the card, and the interpolation
        # magnifies a grid point's ulp by the prototype's slope)
        grid = dict(dtype=dtype, device=win_r.device)
        f1 = _linspace(-1.0, 1.0, hsize[0], **grid)
        f2 = _linspace(-1.0, 1.0, hsize[1], **grid)
        # the radius's sqrt in f64, so its rounding to `dtype` is the correct
        # one on every device (the card's float32 sqrt is off by an ulp at
        # some points, and the slope magnifies that too)
        r = torch.sqrt((f1[None, :] ** 2 + f2[:, None] ** 2).double()).to(dtype)
        return _interp(r, _linspace(0.0, 1.0, n_r, **grid), win_r)
    if len(window) != 2 or isinstance(window, str):
        raise ValueError("window must be a 2-element tuple or list of window specs "
                         "(or a single spec with circular=True)")
    row = firwin(hsize[0], fc, window=window[0], **kw)
    col = firwin(hsize[1], fc, window=window[1], **kw)
    return torch.outer(row, col)


def _device_of(*coefs, device=None) -> torch.device:
    """Where a response runs: the device of the first coefficient given as a
    tensor, else `device` (None: the card)."""
    for c in coefs:
        if isinstance(c, torch.Tensor):
            return c.device
    return target_device(device)


def _coefs(c, device):
    """Filter coefficients as an f64 (or complex128) tensor, on their own
    device if a tensor, else on `device`."""
    if isinstance(c, torch.Tensor):
        t = c
    else:
        t = torch.as_tensor(np.asarray(c), device=device)
    t = torch.atleast_1d(t)
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _freq_grid(n_freqs, sampling_rate, whole, device):
    """(frequencies, angular frequencies w) of n_freqs points over [0, Fs /
    2), or [0, Fs) when `whole`, each start + i * step in f64."""
    span = sampling_rate if whole else sampling_rate / 2.0
    freqs = torch.arange(n_freqs, dtype=torch.float64, device=device) * (span / n_freqs)
    return freqs, 2.0 * math.pi * freqs / sampling_rate


def _polyval_exp(coefs, w):
    """sum_n c[n] e^{-iwn} as one (n_freqs, n_taps) basis product."""
    n = torch.arange(coefs.shape[-1], dtype=torch.float64, device=w.device)
    basis = torch.exp(-1j * (w[:, None] * n[None, :]))
    return basis @ coefs.to(torch.complex128)


def freqz(taps, a=None, *, n_freqs: int = 512, sampling_rate: float = 2.0,
          whole: bool = False, device=None):
    """Frequency response H(w) = B(e^{iw}) / A(e^{iw}) at `n_freqs` points
    over [0, Nyquist) (or [0, Fs) with `whole=True`); `a=None` is the FIR
    case. Returns (frequencies, complex response), scipy.signal.freqz
    semantics, evaluated as a basis product on the device of a tensor
    coefficient, else on `device` (None: the card).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import freqz
    >>> w, h = freqz(torch.tensor([0.5, 0.5]), n_freqs=4)
    >>> w.numpy().round(4), h.abs().numpy().round(4)
    (array([0.  , 0.25, 0.5 , 0.75]), array([1.    , 0.9239, 0.7071, 0.3827]))
    """
    dev = _device_of(taps, a, device=device)
    b = _coefs(taps, dev)
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole, dev)
    resp = _polyval_exp(b, w)
    if a is not None:
        resp = resp / _polyval_exp(_coefs(a, dev), w)
    return freqs, resp


def sosfreqz(sos, *, n_freqs: int = 512, sampling_rate: float = 2.0, whole: bool = False,
             device=None):
    """Frequency response of cascaded second-order sections,
    scipy.signal.sosfreqz semantics, on the device `freqz` takes. Returns
    (frequencies, response).

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import sosfreqz
    >>> w, h = sosfreqz([[0.5, 0.5, 0.0, 1.0, 0.0, 0.0]], n_freqs=4, device="cpu")
    >>> h.abs().numpy().round(4)
    array([1.    , 0.9239, 0.7071, 0.3827])
    """
    if np.ndim(sos) != 2 or np.shape(sos)[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    sos = _coefs(sos, _device_of(sos, device=device))
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole, sos.device)
    resp = torch.ones(w.shape, dtype=torch.complex128, device=sos.device)
    for s in range(sos.shape[0]):
        resp = resp * (_polyval_exp(sos[s, :3], w) / _polyval_exp(sos[s, 3:], w))
    return freqs, resp


def freqz_sos(sos, *, n_freqs: int = 512, sampling_rate: float = 2.0, whole: bool = False,
              device=None):
    """`sosfreqz` under scipy >= 1.15's name.

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import freqz_sos
    >>> w, h = freqz_sos([[0.5, 0.5, 0.0, 1.0, 0.0, 0.0]], n_freqs=8, device="cpu")
    >>> tuple(w.shape), round(float(abs(h[0])), 4)   # unity DC gain
    ((8,), 1.0)
    """
    return sosfreqz(sos, n_freqs=n_freqs, sampling_rate=sampling_rate, whole=whole,
                    device=device)


def freqz_zpk(z, p, k, *, n_freqs: int = 512, sampling_rate: float = 2.0,
              whole: bool = False, device=None):
    """Frequency response of a digital filter in zpk form, as a product over
    the roots, k prod(e^{iw} - z_i) / prod(e^{iw} - p_i),
    scipy.signal.freqz_zpk semantics, on the device `freqz` takes. Returns
    (frequencies, response).

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import freqz_zpk
    >>> w, h = freqz_zpk([1.0], [0.5], 1.0, n_freqs=3, device="cpu")
    >>> h.abs().numpy().round(4)
    array([0.    , 1.1547, 1.3093])
    """
    dev = _device_of(z, p, k, device=device)
    z, p = _coefs(z, dev), _coefs(p, dev)
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole, dev)
    zm = torch.exp(1j * w)
    return freqs, k * _root_product(zm, z) / _root_product(zm, p)


def _root_product(s, roots):
    """prod_i (s - roots_i) per point of s (1.0 with no roots)."""
    if roots.numel() == 0:
        return torch.ones_like(s)
    return torch.prod(s[:, None] - roots.to(torch.complex128)[None, :], dim=-1)


def _freqs_grid(worN, num_like, den_like, kind, device):
    """Angular frequencies of the analog responses on `device`: an int worN
    is the findfreqs log-spaced range, anything else is used as given."""
    if np.ndim(worN) == 0 and isinstance(worN, (int, np.integer)):
        from nx_signal_tpu_torch.ops.ltisys import findfreqs

        num = num_like.cpu().numpy() if isinstance(num_like, torch.Tensor) else num_like
        den = den_like.cpu().numpy() if isinstance(den_like, torch.Tensor) else den_like
        return torch.as_tensor(findfreqs(num, den, int(worN), kind=kind), device=device)
    return _coefs(worN, device)


def _polyval(c, s):
    """Horner's rule, highest power first (numpy.polyval)."""
    out = torch.zeros_like(s)
    for coef in c.to(s.dtype):
        out = out * s + coef
    return out


def freqs(b, a, worN: int = 200, *, device=None):
    """Analog filter frequency response H(jw) = B(jw) / A(jw),
    scipy.signal.freqs semantics: `worN` is a point count (the findfreqs
    grid) or the angular frequencies. Returns (w, h), on the device
    `freqz` takes.

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import freqs
    >>> w, h = freqs([1.0], [1.0, 1.0], worN=[0.5, 1.0, 2.0], device="cpu")
    >>> h.abs().numpy().round(4)
    array([0.8944, 0.7071, 0.4472])
    """
    dev = _device_of(b, a, worN, device=device)
    w = _freqs_grid(worN, b, a, "ba", dev)
    s = 1j * w.real
    return w, _polyval(_coefs(b, dev), s) / _polyval(_coefs(a, dev), s)


def freqs_zpk(z, p, k, worN: int = 200, *, device=None):
    """Analog zpk frequency response k prod(jw - z) / prod(jw - p),
    scipy.signal.freqs_zpk semantics. Returns (w, h), on the device `freqz`
    takes.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.ops.filters import freqs_zpk
    >>> w, h = freqs_zpk([], [-1.0], 1.0, np.asarray([0.5, 1.0, 2.0]), device="cpu")
    >>> h.abs().numpy().round(4)
    array([0.8944, 0.7071, 0.4472])
    """
    dev = _device_of(z, p, k, worN, device=device)
    w = _freqs_grid(worN, z, p, "zp", dev)
    s = (1j * w.real).to(torch.complex128)
    return w, k * _root_product(s, _coefs(z, dev)) / _root_product(s, _coefs(p, dev))


def group_delay(b, a=None, *, n_freqs: int = 512, sampling_rate: float = 2.0,
                whole: bool = False, device=None):
    """Group delay -dphase/dw of a digital filter in samples,
    scipy.signal.group_delay semantics, by the c = b * reverse(conj(a))
    identity: tau(w) = Re(C'(w) / C(w)) - (len(a) - 1), zero where the
    response vanishes. Returns (frequencies, delay), on the device `freqz`
    takes.

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import group_delay
    >>> w, gd = group_delay([0.5, 0.5], n_freqs=4, device="cpu")
    >>> gd.numpy().round(4)
    array([0.5, 0.5, 0.5, 0.5])
    """
    dev = _device_of(b, a, device=device)
    b = _coefs(b, dev)
    a = _coefs(a, dev) if a is not None else torch.ones(1, dtype=b.dtype, device=dev)
    freqs, w = _freq_grid(n_freqs, sampling_rate, whole, dev)
    ar = a.flip(0).conj()
    dtype = torch.promote_types(b.dtype, ar.dtype)
    # the full linear convolution of two short coefficient vectors
    c = (b.to(dtype)[:, None] * ar.to(dtype)[None, :])
    c = torch.stack([torch.diagonal(c.flip(1), offset).sum()
                     for offset in range(ar.shape[0] - 1, -b.shape[0], -1)])
    cr = c * torch.arange(c.shape[0], dtype=torch.float64, device=c.device)
    num = _polyval_exp(cr, w)
    den = _polyval_exp(c, w)
    tau = torch.real(num / den) - (a.shape[0] - 1)
    return freqs, torch.where(den.abs() == 0.0, torch.zeros((), dtype=tau.dtype,
                                                            device=tau.device), tau)


def _savgol_coeffs_np(window_length, polyorder, deriv, delta, pos, use):
    """f64 host math behind savgol_coeffs (design-time)."""
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen - 0.5 if rem == 0 else halflen
    if not 0 <= pos < window_length:
        raise ValueError("pos must be nonnegative and less than window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    if deriv > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1)[:, None]
    a = x[None, :] ** order
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (delta**deriv)
    return np.linalg.lstsq(a, y, rcond=None)[0]


def savgol_coeffs(window_length: int, polyorder: int, *, deriv: int = 0, delta: float = 1.0,
                  pos=None, use: str = "conv", dtype=DEFAULT_FLOAT, device=None):
    """Savitzky-Golay FIR coefficients, scipy.signal.savgol_coeffs
    semantics: the least-squares polynomial-fit weights of the `deriv`-th
    derivative at `pos` of a `window_length` window, in 'conv' (reversed)
    or 'dot' orientation; f64 host math, cast once.

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import savgol_coeffs
    >>> savgol_coeffs(5, 2, device="cpu").numpy().round(4)
    array([-0.0857,  0.3429,  0.4857,  0.3429, -0.0857], dtype=float32)
    """
    return torch.as_tensor(_savgol_coeffs_np(window_length, polyorder, deriv, delta, pos, use),
                           device=target_device(device)).to(dtype)


def _savgol_edge_matrix(window_length, polyorder, deriv, delta, positions):
    """(len(positions), window_length) f64 matrix taking a raw edge window to
    the derivative of its polynomial fit at `positions` (mode='interp')."""
    idx = np.arange(window_length, dtype=np.float64)
    a = idx[:, None] ** np.arange(polyorder + 1)[None, :]
    pinv = np.linalg.pinv(a)  # (polyorder+1, window_length)
    j = np.arange(polyorder + 1)
    # d-th derivative of sum c_j t^j: sum_{j>=d} c_j j!/(j-d)! t^(j-d)
    ff = np.where(j >= deriv, [math.factorial(k) / math.factorial(max(k - deriv, 0))
                               if k >= deriv else 0.0 for k in j], 0.0)
    t = np.asarray(positions, dtype=np.float64)[:, None]
    powers = np.where(j[None, :] >= deriv, t ** np.maximum(j - deriv, 0), 0.0)
    return ((powers * ff[None, :]) @ pinv) / (delta**deriv)


def savgol_filter(x, window_length: int, polyorder: int, *, deriv: int = 0, delta: float = 1.0,
                  axis: int = -1, mode: str = "interp", cval: float = 0.0):
    """Savitzky-Golay smoothing / differentiation filter,
    scipy.signal.savgol_filter semantics (odd window_length): one FIR
    through `ops.convolution.fir_convolve_1d` (a conv1d, cuDNN on the
    card); mode='interp' fits its edges with two host-built (halflen,
    window_length) matrices, the other modes pad as numpy.pad does.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import savgol_filter
    >>> x = torch.tensor([0.0, 1.0, 4.0, 9.0, 16.0, 25.0])
    >>> savgol_filter(x, 5, 2).numpy().round(4)
    array([ 0.,  1.,  4.,  9., 16., 25.], dtype=float32)
    """
    x = as_signal(x)
    if not (x.dtype.is_floating_point or x.is_complex()):
        x = x.to(DEFAULT_FLOAT)
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    if mode not in ("interp", "mirror", "nearest", "constant", "wrap"):
        raise ValueError("mode must be 'mirror', 'constant', 'nearest', 'wrap' or 'interp'")
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    halflen = window_length // 2
    real = x.real.dtype if x.is_complex() else x.dtype
    taps = torch.as_tensor(_savgol_coeffs_np(window_length, polyorder, deriv, delta, None,
                                             "conv"), device=x.device).to(real)

    def fir(sig):
        if sig.is_complex():
            return torch.complex(fir_convolve_1d(sig.real, taps, mode="valid"),
                                 fir_convolve_1d(sig.imag, taps, mode="valid"))
        return fir_convolve_1d(sig, taps, mode="valid")

    if mode == "interp":
        if window_length > n:
            raise ValueError("If mode is 'interp', window_length must be less than or "
                             "equal to the size of x.")
        edge = [torch.as_tensor(_savgol_edge_matrix(window_length, polyorder, deriv, delta,
                                                    pos), device=x.device).to(x.dtype)
                for pos in (np.arange(halflen), np.arange(window_length - halflen,
                                                           window_length))]
        left = x[..., :window_length] @ edge[0].T
        right = x[..., n - window_length:] @ edge[1].T
        return torch.cat([left, fir(x), right], dim=-1).movedim(-1, axis)
    if mode == "constant":
        xp = F.pad(x, (halflen, halflen), value=cval) if not x.is_complex() else torch.cat(
            [torch.full((*x.shape[:-1], halflen), cval, dtype=x.dtype, device=x.device), x,
             torch.full((*x.shape[:-1], halflen), cval, dtype=x.dtype, device=x.device)], -1)
    else:
        pad_mode = {"mirror": "reflect", "nearest": "edge", "wrap": "wrap"}[mode]
        idx = np.pad(np.arange(n), (halflen, halflen), mode=pad_mode)
        xp = x.index_select(-1, torch.as_tensor(idx, device=x.device))
    return fir(xp).movedim(-1, axis)


def detrend(data, *, axis: int = -1, type: str = "linear"):
    """Remove the constant or least-squares linear trend along `axis`,
    scipy.signal.detrend semantics (no breakpoints): the linear fit by the
    closed-form normal equations on a centred time index, batched.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import detrend
    >>> detrend(torch.tensor([1.0, 3.0, 5.0, 7.0])).numpy().round(4)
    array([0., 0., 0., 0.], dtype=float32)
    >>> detrend(torch.tensor([1.0, 2.0, 3.0, 4.0]), type="constant")
    tensor([-1.5000, -0.5000,  0.5000,  1.5000])
    """
    x = as_signal(data)
    if not (x.dtype.is_floating_point or x.is_complex()):
        x = x.to(DEFAULT_FLOAT)
    axis = axis % x.ndim
    if type in ("constant", "c"):
        return x - torch.mean(x, dim=axis, keepdim=True)
    if type not in ("linear", "l"):
        raise ValueError(f"type must be 'linear' or 'constant', got {type!r}")
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = n
    real = x.real.dtype if x.is_complex() else x.dtype
    t = (torch.arange(n, dtype=real, device=x.device) - (n - 1) / 2.0).reshape(shape)
    mean = torch.mean(x, dim=axis, keepdim=True)
    slope = torch.sum((x - mean) * t, dim=axis, keepdim=True) / torch.sum(t * t)
    return x - mean - slope * t


def order_filter(a, domain, rank: int):
    """N-D order-statistic filter, scipy.signal.order_filter semantics: at
    each position the rank-th smallest of the neighbours selected by the
    nonzero entries of `domain` (odd in every dimension, centred, edges
    zero-padded), as one shifted slice per selected position, stacked and
    sorted.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import order_filter
    >>> order_filter(torch.tensor([1.0, 5.0, 2.0, 4.0, 3.0]), torch.ones(3), 1)
    tensor([1., 2., 4., 3., 3.])
    """
    a = as_signal(a)
    dom = domain.cpu().numpy() if isinstance(domain, torch.Tensor) else np.asarray(domain)
    if dom.ndim != a.ndim:
        raise ValueError("domain rank must match input rank")
    if any(s % 2 != 1 for s in dom.shape):
        raise ValueError("Each dimension of domain argument should have an odd number of "
                         "elements.")
    rank = int(rank)
    positions = np.argwhere(dom != 0)
    if not 0 <= rank < len(positions):
        raise ValueError(f"rank ({rank}) must be within [0, {len(positions)}) — the number "
                         "of nonzero domain elements")
    pads = []
    for s in reversed(dom.shape):
        pads += [s // 2, s // 2]
    padded = F.pad(a, pads)
    shifted = [padded[tuple(slice(int(p[d]), int(p[d]) + a.shape[d]) for d in range(a.ndim))]
               for p in positions]
    return torch.sort(torch.stack(shifted, dim=0), dim=0).values[rank]


def medfilt(volume, kernel_size=None):
    """N-D median filter with centred windows and zero-padded edges,
    scipy.signal.medfilt semantics (odd kernel_size, default 3), on
    `order_filter`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import medfilt
    >>> medfilt(torch.tensor([1.0, 9.0, 2.0, 8.0, 3.0]), 3)
    tensor([1., 2., 8., 3., 3.])
    """
    volume = as_signal(volume)
    if kernel_size is None:
        kernel_size = 3
    if np.isscalar(kernel_size):
        kernel_size = (int(kernel_size),) * volume.ndim
    kernel_size = tuple(int(k) for k in kernel_size)
    if len(kernel_size) != volume.ndim:
        raise ValueError("kernel_size must have one element per dimension")
    if any(k % 2 != 1 for k in kernel_size):
        raise ValueError("Each element of kernel_size should be odd.")
    size = int(np.prod(kernel_size))
    return order_filter(volume, np.ones(kernel_size, dtype=bool), (size - 1) // 2)


def medfilt2d(input, kernel_size=3):
    """2-D median filter, scipy.signal.medfilt2d semantics.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.filters import medfilt2d
    >>> medfilt2d(torch.arange(9.0).reshape(3, 3), 3)
    tensor([[0., 1., 0.],
            [1., 4., 2.],
            [0., 4., 0.]])
    """
    input = as_signal(input)
    if input.ndim != 2:
        raise ValueError("input must be 2-D")
    return medfilt(input, kernel_size)


def gammatone(freq, ftype: str, order: int = None, numtaps: int = None, fs: float = None):
    """Gammatone auditory filter design, scipy.signal.gammatone semantics:
    'fir' samples t^(order-1) e^(-2 pi bw t) cos(2 pi f t) with unit gain at
    the centre frequency; 'iir' is Slaney's 8th-order digital gammatone.
    Returns (b, a) as f64 numpy arrays (design-time coefficients).

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import gammatone
    >>> b, a = gammatone(440.0, 'fir', fs=16000.0)
    >>> b.shape, a
    ((240,), array([1.]))
    """
    if fs is None:
        fs = 2.0
    fs = float(fs)
    freq = float(freq)
    if not 0 < freq <= fs / 2:
        raise ValueError(f"The frequency must be between 0 and {fs / 2} "
                         f"(nyquist), but given {freq}.")
    erb = 24.7 + freq / 9.26449  # Glasberg & Moore equivalent bandwidth
    if ftype == "fir":
        order = 4 if order is None else int(order)
        numtaps = max(int(fs * 0.015), 15) if numtaps is None else int(numtaps)
        if not 0 < order <= 24:
            raise ValueError("Invalid order: order must be > 0 and <= 24.")
        t = np.arange(numtaps, dtype=np.float64) / fs
        bw = 1.019 * erb
        b = t ** (order - 1) * np.exp(-2.0 * np.pi * bw * t) * np.cos(2.0 * np.pi * freq * t)
        scale = 2.0 * (2.0 * np.pi * bw) ** order / math.factorial(order - 1) / fs
        return b * scale, np.ones(1)
    if ftype != "iir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    t_s = 1.0 / fs
    bw = 2.0 * np.pi * 1.019 * erb
    fr = 2.0 * np.pi * freq * t_s
    bw_t = bw * t_s
    # the gain at the centre frequency: the product of the four first-order
    # sections' responses
    g1 = -2.0 * np.exp(2j * fr) * t_s
    g2 = 2.0 * np.exp(-bw_t + 1j * fr) * t_s
    g3 = math.sqrt(3.0 + 2.0 ** 1.5) * math.sin(fr)
    g4 = math.sqrt(3.0 - 2.0 ** 1.5) * math.sin(fr)
    g5 = np.exp(2j * fr)
    g = ((g1 + g2 * (math.cos(fr) - g4)) * (g1 + g2 * (math.cos(fr) + g4))
         * (g1 + g2 * (math.cos(fr) - g3)) * (g1 + g2 * (math.cos(fr) + g3)))
    g = abs(g / ((-2.0 / np.exp(2.0 * bw_t) - 2.0 * g5 + 2.0 * (1.0 + g5) / np.exp(bw_t)) ** 4))
    # numerator: a binomial envelope decaying at e^{-bw T}, rotating at fr
    decay = np.exp(-bw_t)
    b = np.array([math.comb(4, q) * (-1) ** q * np.cos(q * fr) * decay ** q
                  for q in range(5)]) * t_s ** 4 / g
    # denominator: the conjugate pole pair to the 4th power
    biquad = np.array([1.0, -2.0 * decay * np.cos(fr), decay ** 2])
    a = np.ones(1)
    for _ in range(4):
        a = np.convolve(a, biquad)
    return b, a


_MLS_TAPS = {
    32: [31, 30, 10], 31: [28], 30: [29, 24, 23], 29: [27], 28: [25], 27: [26, 25, 22],
    26: [25, 24, 20], 25: [22], 24: [23, 22, 17], 23: [18], 22: [21], 21: [19], 20: [17],
    19: [18, 17, 14], 18: [11], 17: [14], 16: [15, 13, 4], 15: [14], 14: [13, 12, 2],
    13: [12, 11, 8], 12: [11, 10, 4], 11: [9], 10: [7], 9: [5], 8: [7, 6, 1], 7: [6], 6: [5],
    5: [3], 4: [3], 3: [2], 2: [1],
}


def max_len_seq(nbits: int, state=None, length: int = None, taps=None, *, device=None):
    """Maximum-length sequence (m-sequence) of a Fibonacci LFSR,
    scipy.signal.max_len_seq semantics: (the sequence of 0/1 as an int8
    tensor on `device`, None the card; the final state as an int8 numpy
    array), default taps for nbits 2..32. The register runs as a host loop
    (a sequential recurrence).

    Examples:

    >>> from nx_signal_tpu_torch.ops.filters import max_len_seq
    >>> seq, state = max_len_seq(3, device="cpu")
    >>> seq, state
    (tensor([1, 1, 1, 0, 1, 0, 0], dtype=torch.int8), array([1, 1, 1], dtype=int8))
    """
    nbits = int(nbits)
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError(f"nbits must be between 2 and 32 when taps is None, got {nbits}")
        taps = _MLS_TAPS[nbits]
    taps = np.unique(np.asarray(taps, dtype=np.int64))[::-1]
    if np.any(taps < 0) or np.any(taps > nbits) or taps.size < 1:
        raise ValueError("taps must be non-empty with values between zero and nbits "
                         "(inclusive)")
    length = (2 ** nbits) - 1 if length is None else int(length)
    if length < 0:
        raise ValueError("length must be greater than or equal to 0")
    state = np.ones(nbits, dtype=np.int8) if state is None else (
        np.asarray(state) != 0).astype(np.int8)
    if state.ndim != 1 or state.shape[0] != nbits:
        raise ValueError("state must be a 1-D array of size nbits")
    if np.all(state == 0):
        raise ValueError("state must not be all zeros")
    device = target_device(device)
    # scipy's circular-buffer register: out = s[idx]; s[idx] ^= xor of
    # s[(idx + t) % nbits] over the taps; idx advances cyclically
    s = [int(v) for v in state]
    offs = [int(t) % nbits for t in taps]
    seq = bytearray(length)
    idx = 0
    for i in range(length):
        out = s[idx]
        fb = out
        for off in offs:
            fb ^= s[(idx + off) % nbits]
        s[idx] = fb
        seq[i] = out
        idx = (idx + 1) % nbits
    final = np.roll(np.asarray(s, dtype=np.int8), -idx)
    return torch.tensor(np.frombuffer(seq, dtype=np.int8), device=device), final
