"""Spectral estimation: periodogram, Welch PSD, cross-spectral density,
coherence, Lomb-Scargle and vector strength (counterpart of
nx_signal_tpu/spectral/estimation.py; scipy.signal semantics, with segment
detrending, density / spectrum scaling and mean / median averaging).

The segments' windowed DFT is `spectral.stft` with 'valid' padding, so a
real signal with fft_length <= 1024 runs kernel B-fft on the card and the
segment matrix is never built. The 'constant' and 'linear' detrends are
applied in the frequency domain by linearity: the removed trend is a linear
functional of the segment, so F((s - trend) w) = F(s w) - coefs @ [F(w);
F(tc w)], with the per-segment (mean, slope) coefficients from one more
blocked contraction (`kernels.dft.blocked_frame_matmul`: with one or two
columns, an exact-f32 matmul of the hop blocks) and the basis spectra built
on the host in f64. A callable detrend takes the materialized frames
(scipy's contract). The mean power of welch is one reduction over the
segments (the squared 2-norm), with no power tensor built.

The one-sided doubling and the density or spectrum scale are positive
constants per bin, so they are applied after the average over segments
(a median commutes with them); a median of an even count of segments is
the mean of its two middle values, as numpy's.
"""

import numpy as np
import torch

from nx_signal_tpu_torch.kernels.dft import _exact_f32, blocked_frame_matmul
from nx_signal_tpu_torch.ops.filters import _median_last
from nx_signal_tpu_torch.ops.windows import get_window
from nx_signal_tpu_torch.spectral.framing import as_windowed
from nx_signal_tpu_torch.spectral.stft import stft
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT, default_complex

__all__ = ["periodogram", "welch", "csd", "coherence", "lombscargle", "vectorstrength"]


def _operand(a, device):
    """A tensor as it is on `device`; anything else as f64, as the JAX
    package (x64 on) takes a Python scalar or a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _float_dtype(*tensors):
    """The JAX package's result_type(..., float32) of real inputs."""
    out = DEFAULT_FLOAT
    for t in tensors:
        out = torch.promote_types(out, t.dtype if t.dtype.is_floating_point else DEFAULT_FLOAT)
    return out


def lombscargle(x, y, freqs, *, precenter: bool = False, normalize: bool = False):
    """Lomb-Scargle periodogram of unevenly sampled data,
    scipy.signal.lombscargle semantics (the per-frequency time offset tau
    that makes the sinusoid basis orthogonal), on the (n_freqs, n_samples)
    phase matrix in the inputs' dtype (f64 inputs stay f64).

    Examples:

    A 2 rad/s sine shows its power at w = 2:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.spectral.estimation import lombscargle
    >>> t = torch.from_numpy(np.linspace(0, 10, 50))
    >>> lombscargle(t, torch.sin(2.0 * t), torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    tensor([ 0.4509, 12.2430,  0.4375], dtype=torch.float64)
    """
    x = as_signal(x)
    y, freqs = _operand(y, x.device), _operand(freqs, x.device)
    if x.ndim != 1 or y.ndim != 1 or x.shape != y.shape:
        raise ValueError("x and y must be 1-D arrays of the same length")
    if freqs.ndim != 1:
        raise ValueError("freqs must be 1-D")
    dtype = _float_dtype(x, y, freqs)
    x, y, freqs = x.to(dtype), y.to(dtype), freqs.to(dtype)
    if precenter:
        y = y - torch.mean(y)
    phase = freqs[:, None] * x[None, :]  # (M, N)
    # tan(2 w tau) = sum sin(2 w x) / sum cos(2 w x)
    tau = torch.atan2(torch.sum(torch.sin(2.0 * phase), dim=1),
                      torch.sum(torch.cos(2.0 * phase), dim=1)) / (2.0 * freqs)
    arg = phase - (freqs * tau)[:, None]
    c, s = torch.cos(arg), torch.sin(arg)
    yc, ys = c @ y, s @ y
    pgram = 0.5 * (yc * yc / torch.sum(c * c, dim=1) + ys * ys / torch.sum(s * s, dim=1))
    if normalize:
        pgram = pgram * (2.0 / torch.sum(y * y))
    return pgram


def vectorstrength(events, period):
    """Vector strength and phase of events relative to one or more periods,
    scipy.signal.vectorstrength semantics: the mean of the unit phasors
    exp(i 2 pi t / T), its magnitude and angle.

    Examples:

    Three events spread evenly over the period partly cancel:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.estimation import vectorstrength
    >>> s, phase = vectorstrength(torch.tensor([0.0, 0.5, 1.0]), 1.0)
    >>> round(float(s), 4), abs(round(float(phase), 4))
    (0.3333, 0.0)
    """
    events = as_signal(events)
    period = _operand(period, events.device)
    if events.ndim != 1:
        raise ValueError("events must be 1-D")
    scalar = period.ndim == 0
    period_v = torch.atleast_1d(period)
    if period_v.ndim != 1:
        raise ValueError("period must be a scalar or 1-D")
    dtype = _float_dtype(events, period_v)
    ang = 2.0 * torch.pi * events.to(dtype)[None, :] / period_v.to(dtype)[:, None]
    vectors = torch.mean(torch.exp(1j * ang), dim=1)
    strength, phase = vectors.abs(), vectors.angle()
    if scalar:
        return strength[0], phase[0]
    return strength, phase


def _median_bias(n: int) -> float:
    """Bias of the median of n exponentially distributed periodogram
    estimates relative to their mean (scipy's _median_bias)."""
    ii_2 = 2.0 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1.0 + np.sum(1.0 / (ii_2 + 1.0) - 1.0 / ii_2))


def _resolve_window(window, segment_length, device):
    is_spec = isinstance(window, str) or (
        isinstance(window, (tuple, list)) and len(window) > 0 and isinstance(window[0], str))
    if is_spec:
        # DFT-even, as scipy's get_window(..., sym=False) default
        return get_window(window, segment_length, periodic=True, dtype=DEFAULT_FLOAT,
                          device=device)
    w = torch.as_tensor(window, device=device)
    if w.ndim != 1:
        raise ValueError(f"window must be 1-D, got shape {tuple(w.shape)}")
    return w


def _validate_detrend(detrend, *, allow_callable=True):
    if detrend in ("constant", "linear", False, None) or (allow_callable and callable(detrend)):
        return
    expected = "'constant', 'linear', False, None" + (" or a callable" if allow_callable
                                                      else "")
    raise ValueError(f"invalid detrend, expected {expected}, got: {detrend}")


def _detrend_columns(frame_length, detrend):
    """(frame_length, k) host matrix whose product with a segment is its
    detrend coefficients: k = 1 (the mean) for 'constant', k = 2 (the mean
    and the slope on the centred ramp) for 'linear'; the centred ramp makes
    the two least-squares basis vectors orthogonal."""
    cols = [np.full((frame_length,), 1.0 / frame_length)]
    if detrend == "linear":
        tc = np.arange(frame_length) - (frame_length - 1) / 2.0
        cols.append(tc / np.sum(tc * tc))
    return np.stack(cols, axis=1)


def _detrend_basis_spectra(window, n_fft, one_sided_fft, detrend):
    """(k, bins) complex64 spectra of the windowed detrend basis, F(w) and
    for 'linear' F(tc w), built in f64 on the host."""
    w64 = window.detach().cpu().numpy().astype(np.float64) if isinstance(
        window, torch.Tensor) else np.asarray(window, np.float64)
    basis = [w64]
    if detrend == "linear":
        tc = np.arange(w64.shape[-1]) - (w64.shape[-1] - 1) / 2.0
        basis.append(tc * w64)
    b = np.stack(basis)
    wk = np.fft.rfft(b, n_fft) if one_sided_fft else np.fft.fft(b, n_fft)
    return wk.astype(np.complex64)


def _subtract_trend(z, coefs, wk):
    """z - coefs @ wk over the (..., segments, bins) spectra, in place on z
    (one exact-f32 product per row block; z is the caller's own)."""
    bins, k = z.shape[-1], wk.shape[0]
    z = z.contiguous()
    with _exact_f32():
        z.view(-1, bins).addmm_(coefs.reshape(-1, k).to(z.dtype), wk.to(z.dtype), alpha=-1)
    return z


def _segment_spectra(x, window, *, stride, n_fft, onesided, detrend, precision):
    """(..., segments, bins) complex spectra of the detrended, windowed
    segments of the (..., L) signal."""
    frame_length = window.shape[-1]
    if x.shape[-1] < frame_length:
        raise ValueError(f"segment_length {frame_length} exceeds signal length {x.shape[-1]}")
    _validate_detrend(detrend)
    real_input = not x.is_complex()
    one_sided_fft = onesided and real_input
    if callable(detrend):
        # scipy's callable contract: the detrender sees the segmented array,
        # segments along the last axis
        frames = as_windowed(x, window_length=frame_length, stride=stride)
        dw = detrend(frames) * window
        return torch.fft.rfft(dw, n_fft) if one_sided_fft else torch.fft.fft(dw, n_fft)
    z, _, _ = stft(x, window, sampling_rate=1.0, fft_length=n_fft,
                   overlap_length=frame_length - stride, window_padding="valid",
                   onesided=one_sided_fft, precision=precision)
    if detrend in ("constant", "linear"):
        cols = _detrend_columns(frame_length, detrend)
        if real_input:
            coefs = blocked_frame_matmul(
                x.to(DEFAULT_FLOAT), torch.as_tensor(cols, dtype=DEFAULT_FLOAT, device=x.device),
                window_length=frame_length, stride=stride, num_frames=z.shape[-2],
                precision=precision)  # (..., segments, k)
        else:
            frames = as_windowed(x, window_length=frame_length, stride=stride)
            coefs = frames @ torch.as_tensor(cols, device=x.device).to(frames.dtype)
        wk = torch.as_tensor(_detrend_basis_spectra(window, n_fft, one_sided_fft, detrend),
                             device=x.device)
        z = _subtract_trend(z, coefs, wk)
    return z


def _spectral_params(window, segment_length, overlap_length, fft_length, scaling, average,
                     sampling_rate, device):
    """Validate and resolve the Welch family's options: (window tensor,
    stride, n_fft, scalar power scale)."""
    w = _resolve_window(window, segment_length, device)
    segment_length = w.shape[-1]
    if overlap_length is None:
        overlap_length = segment_length // 2
    if not 0 <= overlap_length < segment_length:
        raise ValueError(
            f"overlap_length must be in [0, {segment_length}), got: {overlap_length}")
    stride = segment_length - overlap_length
    n_fft = segment_length if fft_length is None else int(fft_length)
    if n_fft < segment_length:
        raise ValueError(f"fft_length ({n_fft}) must be >= segment_length ({segment_length})")
    wf = w.to(DEFAULT_FLOAT)
    if scaling == "density":
        scale = 1.0 / (sampling_rate * torch.sum(wf ** 2))
    elif scaling == "spectrum":
        scale = 1.0 / torch.sum(wf) ** 2
    else:
        raise ValueError(f"invalid scaling, expected 'density' or 'spectrum', got: {scaling}")
    if average not in ("mean", "median"):
        raise ValueError(f"invalid average, expected 'mean' or 'median', got: {average}")
    return w, stride, n_fft, scale


def _cross_power(zx, zy):
    """conj(zx) zy per segment, NaN + NaN j where a part is not finite;
    |zx|^2, real, when zy is zx (`_auto_power`). The reference forms the
    complex product and multiplies it by reals promoted to complex (the
    scale, the one-sided factor, the mean's division, the median's 1j), so
    a non-finite part spreads into NaN in both parts."""
    if zy is zx:
        return _auto_power(zx)
    p = torch.conj(zx) * zy
    return torch.where(torch.isfinite(p.real) & torch.isfinite(p.imag), p,
                       p.new_tensor(complex(torch.nan, torch.nan)))


def _auto_power(z):
    """|z|^2 per segment, NaN where it is not finite, as the reference's
    complex power gives it: conj(z) z has the im part ab - ba, NaN for an
    inf or overflowing ab, and an inf re part meets a 0 im part in the
    later products (`_cross_power`)."""
    vr = torch.view_as_real(z)
    power = (vr * vr).sum(-1)
    return torch.where(torch.isfinite(power), power, torch.nan)


def _power_sum(z):
    """sum over the segment axis (-2) of |z|^2, as one reduction that reads
    the spectra once (the 2-norm, squared; no power tensor is built), NaN
    where it is not finite: a segment whose power is NaN, inf or overflows
    makes the reference's bin NaN (`_auto_power`). No sync and no second
    pass. One case differs: every segment finite but their sum past the
    float range, where the reference's mean is inf and this NaN."""
    total = torch.linalg.vector_norm(z, dim=-2) ** 2
    return torch.where(torch.isfinite(total), total, torch.nan)


def _median_average(pxy):
    """Bias-corrected median over the segment axis (-2) of the (...,
    segments, bins) cross powers, the real and imaginary parts apart."""
    bias = _median_bias(pxy.shape[-2])

    def med(t):
        return _median_last(t.transpose(-1, -2))

    if pxy.is_complex():
        return torch.complex(med(pxy.real), med(pxy.imag)) / bias
    return med(pxy) / bias


def _segment_average(zx, zy, average):
    """The mean, or bias-corrected median, over the segment axis (-2) of the
    cross powers of the (..., segments, bins) spectra; real |X|^2 when zy
    is zx."""
    n_seg = zx.shape[-2]
    if average == "median" and n_seg > 1:
        return _median_average(_cross_power(zx, zy))
    if zy is zx:
        return _power_sum(zx) / n_seg
    return torch.mean(_cross_power(zx, zy), dim=-2)


def _finalize(pxy, scale, *, n_fft, onesided, sampling_rate):
    """Scale the segment average, double the one-sided bins but DC (and
    Nyquist for an even n_fft), and build the frequencies."""
    if onesided:
        factor = np.full((n_fft // 2 + 1,), 2.0, np.float32)
        factor[0] = 1.0
        if n_fft % 2 == 0:
            factor[-1] = 1.0
        freqs = np.fft.rfftfreq(n_fft, 1.0 / sampling_rate)
    else:
        factor = np.ones((n_fft,), np.float32)
        freqs = np.fft.fftfreq(n_fft, 1.0 / sampling_rate)
    pxy = pxy * (scale.to(pxy.device) * torch.as_tensor(factor, device=pxy.device))
    return torch.as_tensor(freqs, dtype=DEFAULT_FLOAT, device=pxy.device), pxy


def _csd(x, y, *, sampling_rate, window, segment_length, overlap_length, fft_length, detrend,
         onesided, scaling, average, precision):
    """(frequencies, P_xy): complex, or real |X|^2 when y is x."""
    same = y is x
    x = as_signal(x)
    y = x if same else torch.as_tensor(y, device=x.device)
    w, stride, n_fft, scale = _spectral_params(window, segment_length, overlap_length,
                                               fft_length, scaling, average, sampling_rate,
                                               x.device)
    if onesided and (x.is_complex() or y.is_complex()):
        raise ValueError("onesided=True requires real input; "
                         "use onesided=False for complex signals")
    kw = dict(stride=stride, n_fft=n_fft, onesided=onesided, detrend=detrend,
              precision=precision)
    zx = _segment_spectra(x, w, **kw)
    zy = zx if y is x else _segment_spectra(y, w, **kw)
    pxy = _segment_average(zx, zy, average)
    return _finalize(pxy, scale, n_fft=n_fft, onesided=onesided, sampling_rate=sampling_rate)


def csd(x, y, *, sampling_rate=1.0, window="hann", segment_length=256, overlap_length=None,
        fft_length=None, detrend="constant", onesided=True, scaling="density", average="mean",
        precision="highest"):
    """Cross power spectral density P_xy by Welch's method, scipy.signal.csd
    semantics: segment both signals, detrend, window, DFT, conj(X) Y per
    segment, average. Returns (frequencies, P_xy), P_xy complex (..., bins);
    the two-sided order is scipy's fftfreq. `average` 'mean' or 'median'
    (bias-corrected); `scaling` 'density' (V**2/Hz) or 'spectrum' (V**2);
    `detrend` 'constant', 'linear', False / None or a callable on the
    segmented array.

    Examples:

    A tone's cross-spectral density with itself peaks at the tone:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.estimation import csd
    >>> x = torch.sin(2 * torch.pi * 0.25 * torch.arange(512))
    >>> f, p = csd(x, x, segment_length=128)
    >>> float(f[p.abs().argmax()]), p.dtype
    (0.25, torch.complex64)
    """
    freqs, pxy = _csd(x, y, sampling_rate=sampling_rate, window=window,
                      segment_length=segment_length, overlap_length=overlap_length,
                      fft_length=fft_length, detrend=detrend, onesided=onesided,
                      scaling=scaling, average=average, precision=precision)
    if not pxy.is_complex():
        pxy = pxy.to(default_complex(pxy.dtype))
    return freqs, pxy


def welch(x, *, sampling_rate=1.0, window="hann", segment_length=256, overlap_length=None,
          fft_length=None, detrend="constant", onesided=True, scaling="density",
          average="mean", precision="highest"):
    """Welch power spectral density estimate, scipy.signal.welch semantics:
    the average of detrended, windowed periodograms of overlapping segments.
    Returns (frequencies, P_xx), P_xx real. The options are `csd`'s.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.estimation import welch
    >>> x = torch.sin(2 * torch.pi * 125.0 * torch.arange(2048) / 1000.0)
    >>> freqs, pxx = welch(x, sampling_rate=1000.0, segment_length=256)
    >>> float(freqs[pxx.argmax()])
    125.0
    """
    x = as_signal(x)
    return _csd(x, x, sampling_rate=sampling_rate, window=window,
                segment_length=segment_length, overlap_length=overlap_length,
                fft_length=fft_length, detrend=detrend, onesided=onesided, scaling=scaling,
                average=average, precision=precision)


def periodogram(x, *, sampling_rate=1.0, window="rectangular", fft_length=None,
                detrend="constant", onesided=True, scaling="density", precision="highest"):
    """Single-segment power spectral density, scipy.signal.periodogram
    semantics: the whole signal as one detrended, windowed segment.
    Returns (frequencies, P_xx).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.estimation import periodogram
    >>> x = torch.sin(2 * torch.pi * 50.0 * torch.arange(512) / 512.0)
    >>> freqs, pxx = periodogram(x, sampling_rate=512.0)
    >>> float(freqs[pxx.argmax()])
    50.0
    """
    x = as_signal(x)
    return welch(x, sampling_rate=sampling_rate, window=window, segment_length=x.shape[-1],
                 overlap_length=0, fft_length=fft_length, detrend=detrend, onesided=onesided,
                 scaling=scaling, average="mean", precision=precision)


def coherence(x, y, *, sampling_rate=1.0, window="hann", segment_length=256,
              overlap_length=None, fft_length=None, detrend="constant", precision="highest"):
    """Magnitude-squared coherence |P_xy|^2 / (P_xx P_yy),
    scipy.signal.coherence semantics. Returns (frequencies, C_xy), real in
    [0, 1]; identically 1 with one segment.

    Examples:

    A signal is coherent with itself at every frequency:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.estimation import coherence
    >>> x = torch.sin(2 * torch.pi * 0.1 * torch.arange(512))
    >>> f, c = coherence(x, x, segment_length=128)
    >>> round(float(c.min()), 5), round(float(c.max()), 5)
    (1.0, 1.0)
    """
    common = dict(sampling_rate=sampling_rate, window=window, segment_length=segment_length,
                  overlap_length=overlap_length, fft_length=fft_length, detrend=detrend,
                  precision=precision)
    x = as_signal(x)
    y = torch.as_tensor(y, device=x.device)
    freqs, pxx = welch(x, **common)
    _, pyy = welch(y, **common)
    _, pxy = csd(x, y, **common)
    return freqs, pxy.abs() ** 2 / (pxx * pyy)
