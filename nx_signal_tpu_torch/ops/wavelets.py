"""Wavelet generators and the continuous wavelet transform (counterpart of
nx_signal_tpu/ops/wavelets.py), scipy.signal's legacy wavelet semantics:
ricker, morlet, morlet2, qmf and cwt.

The wavelets are host f64 tables cast once and moved to the card unless
`device=` says otherwise (the windows' rule, `utils.devices.target_device`);
`qmf` of a tensor stays on its device. `cwt` takes the data through
`utils.devices.as_signal` and computes as the JAX package does: one FFT of
the data at the shared length `fft_fast_length(n + k_max - 1)`, one
batched FFT of the whole wavelet bank (the bank built on the device from
its packed kernels), one product and one inverse FFT, then each scale's
'same' window as a slice. The
output is float32, or complex64 for a complex wavelet or signal.
`_cwt_f64` is the host f64 transform of `find_peaks_cwt`.
"""

import math

import numpy as np
import torch

from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_COMPLEX, DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.shapes import fft_fast_length

__all__ = ["ricker", "morlet", "morlet2", "qmf", "cwt"]


def _host(a) -> np.ndarray:
    """An array or a tensor (any device) as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _ricker_np(points, a):
    """f64 numpy ricker table (the public op's and find_peaks_cwt's default
    wavelet)."""
    a = float(a)
    num = int(np.ceil(points))  # arange semantics: fractional points round up
    x = np.arange(num, dtype=np.float64) - (num - 1.0) / 2.0
    amp = 2.0 / (math.sqrt(3.0 * a) * (math.pi ** 0.25))
    xsq = (x / a) ** 2
    return amp * (1.0 - xsq) * np.exp(-xsq / 2.0)


def ricker(points: int, a, *, dtype=DEFAULT_FLOAT, device=None):
    """Ricker ("Mexican hat") wavelet A (1 - (x/a)^2) e^{-x^2/(2a^2)}, A =
    2 / (sqrt(3a) pi^{1/4}), at x = arange(points) - (points-1)/2; a host
    f64 table cast to `dtype` on `device` (None: the card).

    Examples:

    >>> from nx_signal_tpu_torch.ops.wavelets import ricker
    >>> ricker(5, 1.0, device="cpu").numpy().round(4)
    array([-0.3521,  0.    ,  0.8673,  0.    , -0.3521], dtype=float32)
    """
    return torch.as_tensor(_ricker_np(points, a), device=target_device(device)).to(dtype)


def morlet(points: int, w: float = 5.0, s: float = 1.0, complete: bool = True, *,
           device=None):
    """Legacy Morlet wavelet over x = linspace(-2 pi s, 2 pi s, points):
    pi^{-1/4} e^{i w x} e^{-x^2/2}, less the zero-mean correction
    e^{-w^2/2} when `complete`; complex64 on `device` (None: the card).

    Examples:

    >>> from nx_signal_tpu_torch.ops.wavelets import morlet
    >>> morlet(5, w=5.0, s=0.5, device="cpu").numpy().round(4)
    array([-0.0054-0.j    , -0.    -0.2187j,  0.7511+0.j    , -0.    +0.2187j,
           -0.0054+0.j    ], dtype=complex64)
    """
    x = np.linspace(-s * 2.0 * math.pi, s * 2.0 * math.pi, points)
    out = np.exp(1j * w * x)
    if complete:
        out = out - math.exp(-0.5 * w * w)
    out = out * np.exp(-0.5 * x * x) * (math.pi ** -0.25)
    return torch.as_tensor(out, device=target_device(device)).to(DEFAULT_COMPLEX)


def morlet2(points: int, s, w: float = 5.0, *, device=None):
    """Morlet wavelet in cwt's parameterization: sqrt(1/s) pi^{-1/4}
    e^{i w x} e^{-x^2/2}, x = (arange(points) - (points-1)/2) / s; complex64
    on `device` (None: the card). Its scale s relates to a frequency f as s = w fs / (2 pi f).

    Examples:

    >>> from nx_signal_tpu_torch.ops.wavelets import morlet2
    >>> morlet2(4, 1.0, device="cpu").numpy().round(4)
    array([ 0.0845-0.2287j, -0.5311-0.3967j, -0.5311+0.3967j,  0.0845+0.2287j],
          dtype=complex64)
    """
    s = float(s)
    x = (np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0) / s
    out = (math.pi ** -0.25) * math.sqrt(1.0 / s) * np.exp(1j * w * x) * np.exp(-0.5 * x * x)
    return torch.as_tensor(out, device=target_device(device)).to(DEFAULT_COMPLEX)


def qmf(hk, *, device=None):
    """Quadrature mirror filter of a FIR filter, g[n] = (-1)^n h[N-1-n]; a
    tensor stays on its device, other taps go to `device` (None: the card).

    Examples:

    >>> from nx_signal_tpu_torch.ops.wavelets import qmf
    >>> qmf([1.0, 2.0, 3.0, 4.0], device="cpu")
    tensor([ 4., -3.,  2., -1.])
    """
    if np.ndim(hk) > 1:
        raise ValueError("qmf expects a rank-1 tap vector")
    hk = torch.atleast_1d(hk if isinstance(hk, torch.Tensor)
                          else torch.as_tensor(hk, device=target_device(device)))
    signs = 1 - 2 * (torch.arange(hk.shape[0], device=hk.device) % 2)
    return torch.flip(hk, (0,)) * signs.to(hk.dtype)


def _wavelet_bank(wavelet, widths, n):
    """Per-scale kernels conj(wavelet(min(10*width, n), width))[::-1] as
    host numpy arrays. The port's own wavelets are built on the host for it
    (device='cpu'); any other callable as scipy calls it, (length, width)."""
    kw = {"device": "cpu"} if wavelet in (ricker, morlet, morlet2) else {}
    kernels = []
    for width in widths:
        length = int(math.ceil(min(10 * float(width), float(n))))
        if length < 1:
            raise ValueError(f"width {width} yields an empty wavelet")
        kernels.append(np.conj(_host(wavelet(length, width, **kw))[::-1]))
    return kernels


def cwt(data, wavelet, widths, *, dtype=None):
    """Continuous wavelet transform: row i is the 'same'-mode convolution
    of `data` with conj(reversed wavelet(min(10*widths[i], N), widths[i])),
    scipy.signal.cwt (legacy) semantics; float32 output by default
    (complex64 for complex wavelets). One FFT of the data and one batched
    FFT of the bank (module docstring).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.wavelets import cwt, ricker
    >>> sig = torch.cos(2 * torch.pi * 0.1 * torch.arange(32.0))
    >>> m = cwt(sig, ricker, [1.0, 2.0])
    >>> m.shape
    torch.Size([2, 32])
    >>> round(float(m[0, 0]), 4)
    0.2346
    """
    data = torch.atleast_1d(as_signal(data))
    if data.ndim != 1:
        raise ValueError("cwt expects rank-1 data")
    n = data.shape[0]
    kernels = _wavelet_bank(wavelet, np.atleast_1d(_host(widths)), n)
    is_complex = any(np.iscomplexobj(k) for k in kernels) or data.is_complex()
    if dtype is None:
        dtype = DEFAULT_COMPLEX if is_complex else DEFAULT_FLOAT

    sizes = [k.shape[0] for k in kernels]
    length = fft_fast_length(n + max(sizes) - 1)
    # the bank on the device: zeros, then every kernel's taps at its row
    flat = np.concatenate([i * length + np.arange(size) for i, size in enumerate(sizes)])
    taps = np.concatenate(kernels).astype(np.complex64)
    bank = torch.zeros((len(kernels), length), dtype=DEFAULT_COMPLEX, device=data.device)
    bank.view(-1)[torch.as_tensor(flat, device=data.device)] = torch.as_tensor(
        taps, device=data.device)
    conv = torch.fft.ifft(torch.fft.fft(data.to(DEFAULT_COMPLEX), n=length)[None, :]
                          * torch.fft.fft(bank, dim=-1), dim=-1)
    out = torch.stack([conv[i, (size - 1) // 2:(size - 1) // 2 + n]
                       for i, size in enumerate(sizes)])
    return out.to(dtype) if is_complex else out.real.to(dtype)


def _cwt_f64(data, wavelet, widths):
    """Host f64 cwt (numpy FFT): find_peaks_cwt's ridge decisions (argmax
    and relative-extrema comparisons) must not flip on f32 rounding."""
    data = np.atleast_1d(np.asarray(_host(data), dtype=np.float64))
    n = data.shape[0]
    kernels = _wavelet_bank(wavelet, np.atleast_1d(widths), n)
    length = fft_fast_length(n + max(k.shape[0] for k in kernels) - 1)
    data_f = np.fft.fft(data, n=length)
    out = np.empty((len(kernels), n), dtype=np.float64)
    for i, k in enumerate(kernels):
        full = np.fft.ifft(data_f * np.fft.fft(np.asarray(k, np.complex128), n=length))
        start = (k.shape[0] - 1) // 2
        out[i] = np.real(full[start:start + n])
    return out
