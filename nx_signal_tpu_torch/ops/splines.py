"""B-spline signal processing (counterpart of nx_signal_tpu/ops/splines.py),
scipy.signal's spline family: the B-spline basis functions, the smoothing
IIR cascades with mirror-symmetric boundaries, the 1-D and 2-D B-spline
coefficient transforms, spline evaluation and the separable FIR.

As in the JAX package, the forward and backward recursions run through
the port's `lfilter` / `sosfilt` with `zi` (`ops/iir.py`: the chunked form
at orders 1 and 2), and the mirror-symmetric starting values are
closed-form weighted sums over the whole signal (one exact matrix-vector
product each, no TF32), with scipy's convergence check. `sepfir2d` pads
with numpy's 'symmetric' mode (the edge sample repeated: scipy's
half-sample boundary) and filters each axis with one exact-f32 conv1d.
Signals go through `utils.devices.as_signal` and keep their dtype (float32
at least); leading axes are batched where scipy is 1-D or 2-D only.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.kernels.dft import _exact_f32
from nx_signal_tpu_torch.ops.iir import lfilter, sosfilt
from nx_signal_tpu_torch.ops.waveforms import _as_float as _float_signal
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = [
    "gauss_spline", "cubic_bspline", "quadratic_bspline",
    "symiirorder1", "symiirorder2",
    "cspline1d", "qspline1d", "cspline1d_eval", "qspline1d_eval",
    "cspline2d", "qspline2d", "sepfir2d", "spline_filter",
]


def gauss_spline(x, n: int):
    """Gaussian approximation of the order-`n` B-spline,
    scipy.signal.gauss_spline semantics: the normal density of variance
    (n+1)/12.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import gauss_spline
    >>> gauss_spline(torch.tensor([0.0, 1.0]), 2).numpy().round(4)
    array([0.7979, 0.108 ], dtype=float32)
    """
    x = _float_signal(x)
    sigma2 = (n + 1) / 12.0
    return 1.0 / math.sqrt(2.0 * math.pi * sigma2) * torch.exp(-(x ** 2) / (2.0 * sigma2))


def cubic_bspline(x):
    """Centered cubic (order-3) B-spline basis function.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import cubic_bspline
    >>> cubic_bspline(torch.tensor([0.0, 0.5, 1.0])).numpy().round(4)
    array([0.6667, 0.4792, 0.1667], dtype=float32)
    """
    x = torch.abs(_float_signal(x))
    inner = 2.0 / 3.0 - x ** 2 * (1.0 - x / 2.0)
    outer = (2.0 - x) ** 3 / 6.0
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def quadratic_bspline(x):
    """Centered quadratic (order-2) B-spline basis function.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import quadratic_bspline
    >>> quadratic_bspline(torch.tensor([0.0, 0.5, 1.0])).numpy().round(4)
    array([0.75 , 0.5  , 0.125], dtype=float32)
    """
    x = torch.abs(_float_signal(x))
    inner = 0.75 - x ** 2
    outer = (x - 1.5) ** 2 / 2.0
    return torch.where(x < 0.5, inner, torch.where(x < 1.5, outer, 0.0))


def _is_single(dtype) -> bool:
    return dtype in (torch.float32, torch.complex64)


def _default_precision(precision, dtype):
    """scipy's defaults: the convergence gate |pole|^(n-1) < precision,
    1e-11 in f64, 1e-3 in f32."""
    if precision is None or precision <= 0.0 or precision >= 1.0:
        return 1e-3 if _is_single(dtype) else 1e-11
    return float(precision)


def _check_converged(decay, n, precision, what):
    if abs(decay) ** max(n - 1, 1) > precision:
        raise ValueError(
            f"Sum to find {what} boundary conditions did not converge "
            f"(|pole|^(n-1) = {abs(decay) ** (n - 1):.3e} > {precision:.3e}); "
            "use a longer signal"
        )


def _weighted_sum(x, weights):
    """sum_k weights[k] x[..., k] over the last axis: one exact product,
    in x's dtype promoted with the weights' (complex if they are)."""
    dtype = x.dtype
    if np.iscomplexobj(weights) and not dtype.is_complex:
        dtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    w = torch.as_tensor(np.ascontiguousarray(weights), device=x.device).to(dtype)
    with _exact_f32():
        return x.to(dtype) @ w


def _flip(x):
    return torch.flip(x, (-1,))


def _decay_index(pole, n):
    """k = 0..K-1 for the boundary weights of a pole: past K, |pole|^k (and
    every weight it scales) is exactly 0 in f64, so those weights are
    zeros and need no host math (over a long signal the full _hs / _hc
    tables cost more host time than both recursions on the card); the sums
    still run over all n."""
    r = abs(pole)
    if r == 0.0:
        return np.arange(min(n, 1))
    if r >= 1.0:
        return np.arange(n)
    return np.arange(min(n, math.ceil(1100.0 / -math.log2(r))))


def _padded(weights, n):
    """The boundary weights, zeros past their decay, to n."""
    return np.concatenate([weights, np.zeros(n - weights.shape[0], weights.dtype)])


def symiirorder1(signal, c0, z1, precision: float = -1.0):
    """First-order smoothing IIR cascade with mirror-symmetric boundaries,
    H(z) = c0 / ((1 - z1/z)(1 - z1 z)), scipy.signal.symiirorder1
    semantics, batched over leading axes. The forward starting value is the
    closed-form mirror sum y0 = x[0] + z1 * sum_k z1^k x[k]; both passes
    are `lfilter` with `zi`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import symiirorder1
    >>> symiirorder1(torch.arange(16.0), 0.5, 0.1)[:4].numpy().round(4)
    array([0.0686, 0.6241, 1.2353, 1.8519], dtype=float32)
    """
    x = _float_signal(signal)
    if abs(z1) >= 1:
        raise ValueError("|z1| must be less than 1.0")
    n = x.shape[-1]
    _check_converged(z1, n, _default_precision(precision, x.dtype), "symmetric")
    y0 = x[..., 0] + z1 * _weighted_sum(x, _padded(z1 ** _decay_index(z1, n), n))

    y_rest, _ = lfilter([1.0], [1.0, -z1], x[..., 1:], zi=(z1 * y0)[..., None])
    y1 = torch.cat([y0[..., None], y_rest], dim=-1)

    out_last = (c0 / (1.0 - z1)) * y1[..., -1]
    out_rev, _ = lfilter([c0], [1.0, -z1], _flip(y1[..., :-1]),
                         zi=(z1 * out_last)[..., None])
    return torch.cat([_flip(out_rev), out_last[..., None]], dim=-1)


def _hc(k, cs, r, omega):
    return cs / math.sin(omega) * r ** k * np.sin(omega * (k + 1)) * (k > -1)


def _hs(k, cs, r, omega):
    rsq = r * r
    c0 = (cs * cs * (1 + rsq) / (1 - rsq)
          / (1 - 2 * rsq * math.cos(2 * omega) + rsq * rsq))
    gamma = (1 - rsq) / (1 + rsq) / math.tan(omega)
    ak = np.abs(k)
    return c0 * r ** ak * (np.cos(omega * ak) + gamma * np.sin(omega * ak))


def _symiirorder2_core(x, r, omega, precision, smooth_ics: bool):
    """The second-order mirror-symmetric cascade. symiirorder2 starts the
    forward pass with y1 = hc(0) x1 + hc(1) x0 + sum hc(k+2) x[k], scipy's
    cubic smoothing spline (_cubic_smooth_coeff) with y1 = hc(0) x0 +
    hc(1) x1 + sum hc(k+2) x[k]; both are kept. The boundary sums run over
    the whole signal (scipy truncates them below `precision`)."""
    n = x.shape[-1]
    _check_converged(r, n, precision, "symmetric")
    rsq = r * r
    a2 = 2 * r * math.cos(omega)
    a3 = -rsq
    cs = 1 - 2 * r * math.cos(omega) + rsq
    sos = [[cs, 0.0, 0.0, 1.0, -a2, -a3]]

    k = _decay_index(r, n)
    hc0, hc1 = float(_hc(0, cs, r, omega)), float(_hc(1, cs, r, omega))
    y0 = hc0 * x[..., 0] + _weighted_sum(x, _padded(_hc(k + 1, cs, r, omega), n))
    first, second = (x[..., 0], x[..., 1]) if smooth_ics else (x[..., 1], x[..., 0])
    y1 = hc0 * first + hc1 * second + _weighted_sum(x, _padded(_hc(k + 2, cs, r, omega), n))

    def _zi(ic0, ic1):
        # the DF2T biquad state that reproduces out[k] = cs u[k] + a2 out[k-1]
        # + a3 out[k-2] with out[-1] = ic1, out[-2] = ic0
        return torch.stack([a3 * ic0 + a2 * ic1, a3 * ic1], dim=-1)[None]

    y_rest, _ = sosfilt(sos, x[..., 2:], zi=_zi(y0, y1))
    y_fwd = torch.cat([y0[..., None], y1[..., None], y_rest], dim=-1)

    # sums over x reversed: weights c[k] on x[n-1-k] are c reversed on x
    b0 = _weighted_sum(x, _padded(_hs(k, cs, r, omega) + _hs(k + 1, cs, r, omega), n)[::-1])
    b1 = _weighted_sum(x, _padded(_hs(k - 1, cs, r, omega) + _hs(k + 2, cs, r, omega),
                                  n)[::-1])
    out_rev, _ = sosfilt(sos, _flip(y_fwd[..., :-2]), zi=_zi(b0, b1))
    return torch.cat([_flip(out_rev), b1[..., None], b0[..., None]], dim=-1)


def symiirorder2(input, r, omega, precision: float = -1.0):
    """Second-order smoothing IIR cascade with mirror-symmetric boundaries,
    H(z) = cs^2 / ((1 - a2/z - a3/z^2)(1 - a2 z - a3 z^2)), a2 = 2 r
    cos(omega), a3 = -r^2, cs = 1 - 2 r cos(omega) + r^2;
    scipy.signal.symiirorder2 semantics, batched over leading axes; both
    passes are `sosfilt` with `zi`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import symiirorder2
    >>> symiirorder2(torch.arange(24.0), 0.5, 0.3)[:4].numpy().round(4)
    array([1.2119, 1.6048, 2.2748, 3.1113], dtype=float32)
    """
    x = _float_signal(input)
    if r >= 1.0:
        raise ValueError("r must be less than 1.0")
    return _symiirorder2_core(x, r, omega, _default_precision(precision, x.dtype),
                              smooth_ics=False)


def _bspline_coeffs(x, zi_pole, scale):
    """The cubic / quadratic interpolation prefilter: forward and backward
    first-order recursions with scipy's mirror starting values, batched over
    leading axes."""
    x = _float_signal(x)
    n = x.shape[-1]
    if n == 1:
        yplus = x[..., 0] + zi_pole * x[..., 0]
        return (zi_pole / (zi_pole - 1.0) * yplus)[..., None] * scale
    y0 = x[..., 0] + zi_pole * _weighted_sum(x, _padded(zi_pole ** _decay_index(zi_pole, n), n))
    y_rest, _ = lfilter([1.0], [1.0, -zi_pole], x[..., 1:], zi=(zi_pole * y0)[..., None])
    yplus = torch.cat([y0[..., None], y_rest], dim=-1)
    out_last = zi_pole / (zi_pole - 1.0) * yplus[..., -1]
    out_rev, _ = lfilter([-zi_pole], [1.0, -zi_pole], _flip(yplus[..., :-1]),
                         zi=(zi_pole * out_last)[..., None])
    return torch.cat([_flip(out_rev), out_last[..., None]], dim=-1) * scale


def cspline1d(signal, lamb: float = 0.0):
    """Cubic B-spline coefficients of a uniformly sampled signal,
    scipy.signal.cspline1d semantics (lamb=0: exact interpolation; else the
    smoothing spline through the second-order cascade at the smoothing root
    of `lamb`).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import cspline1d
    >>> cspline1d(torch.tensor([0.0, 1.0, 2.0, 3.0])).numpy().round(4)
    array([-0.2082,  1.0698,  1.929 ,  3.2142], dtype=float32)
    """
    if lamb != 0.0:
        x = _float_signal(signal)
        r, omega = _smooth_root(lamb)
        return _symiirorder2_core(x, r, omega, _default_precision(-1.0, x.dtype),
                                  smooth_ics=True)
    return _bspline_coeffs(signal, -2.0 + math.sqrt(3.0), 6.0)


def qspline1d(signal, lamb: float = 0.0):
    """Quadratic B-spline coefficients, scipy.signal.qspline1d semantics
    (no smoothing for quadratic splines, as in scipy).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import qspline1d
    >>> qspline1d(torch.tensor([0.0, 1.0, 2.0, 3.0])).numpy().round(4)
    array([-0.1465,  1.0293,  1.9706,  3.1471], dtype=float32)
    """
    if lamb != 0.0:
        raise ValueError("lambda must be zero for quadratic splines")
    return _bspline_coeffs(signal, -3.0 + 2.0 * math.sqrt(2.0), 8.0)


def _smooth_root(lamb):
    """(r, omega) of the cubic smoothing spline's pole for `lamb` (scipy's
    compute_root_from_lambda)."""
    tmp = math.sqrt(3 + 144 * lamb)
    xi = 1 - 96 * lamb + 24 * lamb * tmp
    omega = math.atan(math.sqrt((144 * lamb - 1.0) / xi))
    r = ((24 * lamb - 1 - math.sqrt(xi)) / (24 * lamb)
         * math.sqrt(48 * lamb + 24 * lamb * tmp) / math.sqrt(xi))
    return r, omega


def _mirror_fold(t, n):
    """Sample positions reflected into [0, n-1] (whole-sample mirror,
    period 2(n-1))."""
    if n == 1:
        return torch.zeros_like(t)
    period = 2.0 * (n - 1)
    t = torch.remainder(torch.abs(t), period)
    return torch.minimum(t, period - t)


def _spline_eval(cj, newx, dx, x0, basis, half_support):
    cj = as_signal(cj)
    newx = torch.as_tensor(newx, device=cj.device)
    if not newx.dtype.is_floating_point:
        newx = newx.to(DEFAULT_FLOAT)
    newx = (newx - x0) / dx
    n = cj.shape[-1]
    if n == 0:
        raise ValueError("Spline coefficients must not be empty.")
    t = _mirror_fold(newx, n)
    lower = torch.floor(t - half_support).to(torch.int64) + 1
    idx = lower[..., None] + torch.arange(int(2 * half_support), device=cj.device)
    # scipy folds the evaluation point but clamps the neighbour indices
    w = basis(t[..., None] - idx)
    return torch.sum(cj[..., idx.clamp(0, n - 1)] * w, dim=-1)


def cspline1d_eval(cj, newx, dx: float = 1.0, x0=0):
    """A cubic spline evaluated from its coefficients at any points, mirror
    symmetric at the edges, scipy.signal.cspline1d_eval semantics (a gather
    and 4-tap B-spline weights).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import cspline1d, cspline1d_eval
    >>> cj = cspline1d(torch.tensor([0.0, 1.0, 2.0, 3.0]))
    >>> cspline1d_eval(cj, torch.tensor([0.5, 1.5, 2.5])).numpy().round(4)
    array([0.4487, 1.4996, 2.5537], dtype=float32)
    """
    return _spline_eval(cj, newx, float(dx), x0, cubic_bspline, 2.0)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0=0):
    """A quadratic spline evaluated from its coefficients,
    scipy.signal.qspline1d_eval semantics.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import qspline1d, qspline1d_eval
    >>> cj = qspline1d(torch.tensor([0.0, 1.0, 2.0, 3.0]))
    >>> qspline1d_eval(cj, torch.tensor([0.5, 1.5, 2.5])).numpy().round(4)
    array([0.4414, 1.5   , 2.5588], dtype=float32)
    """
    return _spline_eval(cj, newx, float(dx), x0, quadratic_bspline, 1.5)


def _fir_last_axis(a, h):
    """Each row of `a` (..., L) convolved with the odd-length taps `h` over
    its 'symmetric' padding, same length out: one exact conv1d."""
    if a.is_complex():
        return torch.complex(_fir_last_axis(a.real, h), _fir_last_axis(a.imag, h))
    k, length = h.shape[0], a.shape[-1]
    half = k // 2
    if half:
        # numpy's 'symmetric' pad: the edge sample repeated (x[-1] = x[0])
        idx = np.pad(np.arange(length), half, mode="symmetric")
        a = a[..., torch.as_tensor(idx, device=a.device)]
    rows = a.reshape(-1, 1, a.shape[-1])
    with _exact_f32():
        out = F.conv1d(rows, torch.flip(h, (0,)).view(1, 1, k))
    return out.reshape(*a.shape[:-1], length)


def sepfir2d(input, hrow, hcol):
    """Separable 2-D FIR with mirror-symmetric boundaries,
    scipy.signal.sepfir2d semantics: odd-length `hrow` along the rows, `hcol`
    along the columns, the output the input's shape.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.splines import sepfir2d
    >>> h = [1.0, 2.0, 1.0]
    >>> sepfir2d(torch.arange(9.0).reshape(3, 3), h, h)
    tensor([[ 16.,  28.,  40.],
            [ 52.,  64.,  76.],
            [ 88., 100., 112.]])
    """
    x = _float_signal(input)
    if x.ndim != 2:
        raise ValueError("input must be 2-D")
    real = x.real.dtype if x.is_complex() else x.dtype
    hrow, hcol = (torch.as_tensor(h, device=x.device).reshape(-1).to(real)
                  for h in (hrow, hcol))
    if hrow.shape[0] % 2 != 1 or hcol.shape[0] % 2 != 1:
        raise ValueError("hrow and hcol must be odd length")
    out = _fir_last_axis(x, hrow)
    return _fir_last_axis(out.T, hcol).T


def _c2d_precision(precision, dtype):
    if precision < 0.0 or precision >= 1.0:
        return 1e-3 if _is_single(dtype) else 1e-6
    return precision


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D cubic B-spline coefficients, scipy.signal.cspline2d semantics:
    the separable symiirorder1 (exact) or symiirorder2 (smoothing, lamb >
    1/144) prefilter along both axes.

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.splines import cspline2d, sepfir2d
    >>> x = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 24)).astype(np.float32))
    >>> c = cspline2d(x, 0.0)
    >>> h = torch.tensor([1.0, 4.0, 1.0]) / 6.0
    >>> bool((sepfir2d(c, h, h) - x).abs().max() < 1e-5)   # interpolation
    True
    """
    x = _float_signal(signal)
    if x.ndim != 2:
        raise ValueError("signal must be 2-D")
    precision = _c2d_precision(precision, x.dtype)
    if lamb <= 1.0 / 144.0:
        r = -2.0 + math.sqrt(3.0)
        out = symiirorder1(x, -r * 6.0, r, precision=precision)
        return symiirorder1(out.T, -r * 6.0, r, precision=precision).T
    r, omega = _smooth_root(lamb)
    out = symiirorder2(x, r, omega, precision=precision)
    return symiirorder2(out.T, r, omega, precision=precision).T


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D quadratic B-spline coefficients, scipy.signal.qspline2d
    semantics.

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.splines import qspline2d, sepfir2d
    >>> x = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 24)).astype(np.float32))
    >>> q = qspline2d(x, 0.0)
    >>> h = torch.tensor([1.0, 6.0, 1.0]) / 8.0
    >>> bool((sepfir2d(q, h, h) - x).abs().max() < 1e-5)   # interpolation
    True
    """
    x = _float_signal(signal)
    if x.ndim != 2:
        raise ValueError("signal must be 2-D")
    if lamb > 0:
        raise ValueError("lambda must be negative or zero")
    precision = _c2d_precision(precision, x.dtype)
    r = -3.0 + 2.0 * math.sqrt(2.0)
    out = symiirorder1(x, -r * 8.0, r, precision=precision)
    return symiirorder1(out.T, -r * 8.0, r, precision=precision).T


def spline_filter(iin, lmbda: float = 5.0):
    """Smoothing-spline filter of a 2-D array, scipy.signal.spline_filter
    semantics: cubic smoothing coefficients, then the separable [1, 4, 1]/6
    B-spline reconstruction.

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.splines import spline_filter
    >>> x = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 24)).astype(np.float32))
    >>> sf = spline_filter(x, lmbda=5.0)
    >>> sf.shape, bool(abs(float(sf.mean() - x.mean())) < 1e-5)  # DC kept
    (torch.Size([24, 24]), True)
    """
    x = as_signal(iin)
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        raise TypeError(f"Invalid data type for iin: {x.dtype}")
    hcol = torch.tensor([1.0, 4.0, 1.0], dtype=torch.float64) / 6.0
    return sepfir2d(cspline2d(x, lmbda), hcol, hcol).to(x.dtype)
