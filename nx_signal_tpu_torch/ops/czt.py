"""Chirp-Z transform and zoom FFT (counterpart of nx_signal_tpu/ops/czt.py),
scipy.signal.czt / zoom_fft semantics: czt, zoom_fft, czt_points, CZT,
ZoomFFT.

Two routes, as in the JAX package:

- n*m up to `_MAX_MATMUL_NM` (2^19, set from the card's times: on an H100
  80GB HBM3 at 700 W, 768 rows, the product led at 2^18, 0.092 against
  0.139 ms, tied at 2^19, and Bluestein led from 2^20, 0.194 against 0.250
  ms, to 2^23, 0.239 against 1.028; `chip_smoke.py` phase 13; the JAX
  package's TPU cut is 2^21): the transform is one product,
  X = x @ W with W[n, k] = a^-n w^(nk), a complex64 matmul without TF32
  (`kernels/dft.py:_exact_f32`; the JAX package asks for precision
  'highest' there);
- past it, Bluestein's algorithm: nk = (n^2 + k^2 - (k-n)^2) / 2 turns the
  transform into one linear convolution, done with FFTs of the power-of-two
  length `fft_fast_length(n + m - 1)` (torch.fft on the card).

The chirp tables are built on the host in f64 (`_CztPlan`) and cast to
complex64 once; a plan keeps its device copies on itself, one per device,
so a `CZT` / `ZoomFFT` object called again on the card copies nothing. The
signal goes through `utils.devices.as_signal`; `czt_points` goes to the
card unless `device=` says otherwise (`utils.devices.target_device`).
"""

import math

import numpy as np
import torch

from nx_signal_tpu_torch.kernels.dft import _exact_f32
from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_COMPLEX
from nx_signal_tpu_torch.utils.shapes import fft_fast_length

__all__ = ["czt", "zoom_fft", "czt_points", "CZT", "ZoomFFT"]

# n*m above this takes Bluestein's route (module docstring)
_MAX_MATMUL_NM = 1 << 19


def _as_scalar_complex(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return complex(np.asarray(v).reshape(()))


def _chirp_powers(base, exponents):
    """base**exponents with f64 phase accuracy: base = r e^{i t} ->
    r**e * exp(i t e), in numpy f64."""
    base = _as_scalar_complex(base)
    exponents = np.asarray(exponents, dtype=np.float64)
    r = abs(base)
    t = math.atan2(base.imag, base.real)
    mag = np.exp(exponents * math.log(r)) if r != 1.0 else 1.0
    return (mag * np.exp(1j * t * exponents)).astype(np.complex128)


def czt(x, m: int = None, w=None, a=1.0 + 0.0j, *, axis: int = -1):
    """Chirp-Z transform X[k] = sum_n x[n] z_k^{-n} along the spiral
    z_k = a * w^{-k}, k = 0..m-1, scipy.signal.czt semantics (defaults
    m = len(x), w = exp(-2j*pi/m), a = 1: the plain DFT). complex64 out.

    Off the unit circle (|w| != 1) Bluestein's chirps span
    e^{±|log w| n^2/2} and cancel catastrophically (scipy's czt loses every
    digit by n ~ 100 at |w| = e^{-0.01}); the matmul route has no such
    growth.

    Examples:

    With the defaults czt is the DFT: a constant has all its energy in bin 0.

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.czt import czt
    >>> czt(torch.ones(4), m=4).abs().numpy().round(4)
    array([4., 0., 0., 0.], dtype=float32)
    """
    x = as_signal(x)
    return _CztPlan(x.shape[axis], m, w, a).apply(x, axis=axis)


class _CztPlan:
    """The chirp tables of a fixed (n, m, w, a) transform, built once on the
    host in f64; their device copies are kept per device."""

    def __init__(self, n, m=None, w=None, a=1.0 + 0.0j):
        if n <= 0:
            raise ValueError("input must be nonempty along the transform axis")
        if m is None:
            m = n
        if m <= 0:
            raise ValueError(f"m must be positive, got {m}")
        if w is None:
            w = np.exp(-2j * np.pi / m)
        self.n, self.m = int(n), int(m)
        self.w = _as_scalar_complex(w)
        self.a = _as_scalar_complex(a)
        self._copies = {}

        n_idx = np.arange(self.n, dtype=np.float64)
        a_chirp = _chirp_powers(self.a, -n_idx)  # a^{-n}
        self._matmul = self.n * self.m <= _MAX_MATMUL_NM
        if self._matmul:
            nk = n_idx[:, None] * np.arange(self.m, dtype=np.float64)[None, :]
            self._tables = ((a_chirp[:, None] * _chirp_powers(self.w, nk)).astype(np.complex64),)
            return
        # Bluestein: nk = (n^2 + k^2 - (k-n)^2) / 2
        m, n, w = self.m, self.n, self.w
        k_idx = np.arange(m, dtype=np.float64)
        wn2 = _chirp_powers(w, n_idx * n_idx / 2.0)  # w^{n^2/2}
        wk2 = _chirp_powers(w, k_idx * k_idx / 2.0)  # w^{k^2/2}
        length = fft_fast_length(n + m - 1)
        # v[j] = w^{-j^2/2} for j in -(n-1)..(m-1), circularly embedded
        v = np.zeros(length, dtype=np.complex128)
        v[:m] = _chirp_powers(w, -(k_idx * k_idx) / 2.0)
        if n > 1:
            j = np.arange(1, n, dtype=np.float64)
            v[length - n + 1:] = _chirp_powers(w, -(j * j) / 2.0)[::-1]
        self._length = length
        self._tables = tuple(t.astype(np.complex64)
                             for t in (np.fft.fft(v), a_chirp * wn2, wk2))

    def _on(self, device):
        if device not in self._copies:
            self._copies[device] = tuple(torch.as_tensor(t, device=device)
                                         for t in self._tables)
        return self._copies[device]

    def apply(self, x, *, axis: int = -1):
        x = as_signal(x)
        if x.shape[axis] != self.n:
            raise ValueError(f"CZT defined for length {self.n}, got {x.shape[axis]}")
        xm = torch.movedim(x, axis, -1).to(DEFAULT_COMPLEX)
        if self._matmul:
            (weights,) = self._on(x.device)
            with _exact_f32():
                out = xm @ weights
            return torch.movedim(out, -1, axis)
        v_f, pre, post = self._on(x.device)
        conv = torch.fft.ifft(torch.fft.fft(xm * pre, n=self._length, dim=-1) * v_f, dim=-1)
        return torch.movedim(conv[..., :self.m] * post, -1, axis)

    def points(self, device=None):
        """The z-plane evaluation points z_k = a * w^{-k}, on `device`
        (None: the card)."""
        return czt_points(self.m, self.w, self.a, device=device)


def czt_points(m: int, w=None, a=1.0 + 0.0j, *, device=None):
    """The m points z_k = a * w^{-k} of the CZT's spiral,
    scipy.signal.czt_points semantics (w defaults to exp(-2j*pi/m): the
    unit circle of the plain DFT); host f64 chirp powers cast to complex64
    on `device` (None: the card).

    Examples:

    >>> from nx_signal_tpu_torch.ops.czt import czt_points
    >>> czt_points(3, device="cpu").numpy().round(4)
    array([ 1. +0.j   , -0.5+0.866j, -0.5-0.866j], dtype=complex64)
    """
    m = int(m)
    if m <= 0:
        raise ValueError(f"m must be positive, got {m}")
    if w is None:
        w = np.exp(-2j * np.pi / m)
    pts = _as_scalar_complex(a) * _chirp_powers(w, -np.arange(m, dtype=np.float64))
    return torch.as_tensor(pts.astype(np.complex64), device=target_device(device))


class CZT:
    """Callable chirp-Z transform of fixed length, scipy.signal.CZT
    semantics: the chirp tables are built once, and their device copies
    kept on the object.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.czt import CZT
    >>> plan = CZT(8, m=8)
    >>> plan(torch.ones(8))[:2].abs().numpy().round(4)
    array([8., 0.], dtype=float32)
    """

    def __init__(self, n: int, m: int = None, w=None, a=1.0 + 0.0j):
        self._plan = _CztPlan(n, m, w, a)

    def __call__(self, x, *, axis: int = -1):
        return self._plan.apply(x, axis=axis)

    @property
    def n(self):
        return self._plan.n

    @property
    def m(self):
        return self._plan.m

    @property
    def w(self):
        return self._plan.w

    @property
    def a(self):
        return self._plan.a

    def points(self, device=None):
        """The z-plane points this transform evaluates at, on `device`
        (None: the card)."""
        return self._plan.points(device)


def _parse_band(fn, fs):
    fn = np.atleast_1d(np.asarray(fn, dtype=np.float64))
    if fn.size == 2:
        f1, f2 = float(fn[0]), float(fn[1])
    elif fn.size == 1:
        f1, f2 = 0.0, float(fn[0])
    else:
        raise ValueError("fn must be a scalar or a pair [f1, f2]")
    if not 0 <= f1 <= f2 <= fs / 2:
        raise ValueError(f"fn must satisfy 0 <= f1 <= f2 <= fs/2, got {fn}")
    return f1, f2


def _zoom_spiral(f1, f2, m, fs, endpoint):
    """(w, a) of the unit-circle arc [f1, f2] at m points."""
    denom = (m - 1) if endpoint else m
    return np.exp(-2j * np.pi * (f2 - f1) / (denom * fs)), np.exp(2j * np.pi * f1 / fs)


class ZoomFFT(CZT):
    """Callable zoom FFT of fixed length over a fixed band,
    scipy.signal.ZoomFFT semantics: a CZT along the unit-circle arc
    [f1, f2] (see `zoom_fft`).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.czt import ZoomFFT
    >>> ZoomFFT(16, [0.1, 0.3], m=4, fs=1.0)(torch.ones(16)).shape
    torch.Size([4])
    """

    def __init__(self, n: int, fn, m: int = None, *, fs: float = 2.0,
                 endpoint: bool = False):
        f1, f2 = _parse_band(fn, fs)
        if m is None:
            m = n
        super().__init__(n, m, *_zoom_spiral(f1, f2, m, fs, endpoint))
        self.f1, self.f2, self.fs = f1, f2, fs


def zoom_fft(x, fn, m: int = None, *, fs: float = 2.0, endpoint: bool = False,
             axis: int = -1):
    """The DFT of `x` over the band `fn` = [f1, f2] (or [0, fn] for a
    scalar) at `m` points, scipy.signal.zoom_fft semantics: a czt along the
    unit circle, without the full spectrum.

    Examples:

    Three bins over [0.2, 0.3] cycles/sample of a 0.125-cycle cosine:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.czt import zoom_fft
    >>> x = torch.cos(2 * torch.pi * 0.125 * torch.arange(16.0))
    >>> zoom_fft(x, [0.2, 0.3], m=3, fs=1.0).abs().numpy().round(3)
    array([1.522, 1.434, 1.175], dtype=float32)
    """
    f1, f2 = _parse_band(fn, fs)
    x = as_signal(x)
    if m is None:
        m = x.shape[axis]
    return czt(x, m, *_zoom_spiral(f1, f2, m, fs, endpoint), axis=axis)
