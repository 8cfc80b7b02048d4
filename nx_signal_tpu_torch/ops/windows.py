"""Window functions (counterpart of nx_signal_tpu/ops/windows.py).

The cosine-sum windows hann, hamming and blackman, and bartlett and
triangular, are computed in the requested dtype, as the JAX package
computes them. Every other window (kaiser and its derived window, the
general_cosine family, tukey, dpss, chebwin, taylor, ...) is design-time
math built on the host in f64 numpy (scipy.signal.windows semantics) and
cast once. Each takes the periodic (DFT-even, default) vs symmetric
(filter-design) distinction where the JAX package does: the periodic
window of length n is the symmetric window of length n + 1 without its
last sample. A window is built on the card unless `device=` says
otherwise (`utils.devices.target_device`); code that reads a window as
numpy asks for `device='cpu'`.
"""

import math

import numpy as np
import torch

from nx_signal_tpu_torch.utils.devices import target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["rectangular", "bartlett", "triangular", "blackman", "hamming", "hann", "kaiser",
           "general_cosine", "general_hamming", "blackmanharris", "nuttall", "flattop",
           "bohman", "cosine", "barthann", "parzen", "lanczos", "gaussian",
           "general_gaussian", "tukey", "exponential", "taylor", "chebwin", "dpss",
           "kaiser_bessel_derived", "boxcar", "triang", "get_window"]


def _cosine_window(n: int, coefs, periodic: bool, dtype, device):
    """General cosine-sum window: sum_k (-1)^k a_k cos(2 pi k i / (L-1)),
    computed on `device` (None: the card)."""
    device = target_device(device)
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
    >>> blackman(8, periodic=False, device="cpu").numpy().round(4)
    array([-0.    ,  0.0905,  0.4592,  0.9204,  0.9204,  0.4592,  0.0905,
           -0.    ], dtype=float32)
    """
    return _cosine_window(n, (0.42, 0.5, 0.08), periodic, dtype, device)


def hamming(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Hamming window 0.54 - 0.46 cos.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import hamming
    >>> hamming(6, periodic=False, device="cpu").numpy().round(4)
    array([0.08  , 0.3979, 0.9121, 0.9121, 0.3979, 0.08  ], dtype=float32)
    """
    return _cosine_window(n, (0.54, 0.46), periodic, dtype, device)


def hann(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Hann window 0.5 (1 - cos).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> hann(4, device="cpu")
    tensor([0.0000, 0.5000, 1.0000, 0.5000])
    """
    return _cosine_window(n, (0.5, 0.5), periodic, dtype, device)


def _host_window(n: int, periodic: bool, dtype, device, build):
    """Symmetric->periodic plumbing for windows built in f64 numpy, then
    moved to `device` (None: the card)."""
    device = target_device(device)
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
    >>> general_cosine(6, [0.6, 0.4], periodic=False, device="cpu").numpy().round(4)
    array([0.2   , 0.4764, 0.9236, 0.9236, 0.4764, 0.2   ], dtype=float32)
    """
    def build(length):
        fac = np.linspace(-np.pi, np.pi, length)
        w = np.zeros(length)
        for k, a in enumerate(coefs):
            w += a * np.cos(k * fac)
        return w
    return _host_window(n, periodic, dtype, device, build)




def rectangular(n: int, *, dtype=torch.int32, device=None):
    """All-ones window; int32 by default, as the JAX package's.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import rectangular
    >>> rectangular(5, device="cpu")
    tensor([1, 1, 1, 1, 1], dtype=torch.int32)
    """
    return torch.ones((n,), dtype=dtype, device=target_device(device))


def bartlett(n: int, *, dtype=DEFAULT_FLOAT, device=None):
    """Periodic Bartlett window: rises 2i/n, then falls 2 - 2i/n, split at
    n//2 + n%2 (torch.bartlett_window(periodic=True), not the symmetric
    scipy.signal.windows.bartlett).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import bartlett
    >>> bartlett(6, device="cpu").numpy().round(4)
    array([0.    , 0.3333, 0.6667, 1.    , 0.6667, 0.3333], dtype=float32)
    """
    i = torch.arange(n, dtype=dtype, device=target_device(device))
    left_size = n // 2 + n % 2
    return torch.where(i < left_size, i * 2.0 / n, 2.0 - i * 2.0 / n).to(dtype)


def triangular(n: int, *, dtype=DEFAULT_FLOAT, device=None):
    """Symmetric triangular window, scipy.signal.windows.triang semantics:
    odd n peaks at 1, even n has a two-sample plateau.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import triangular
    >>> triangular(5, device="cpu").numpy().round(4)
    array([0.3333, 0.6667, 1.    , 0.6667, 0.3333], dtype=float32)
    """
    half = (n + 1) // 2
    idx = torch.arange(1, half + 1, dtype=dtype, device=target_device(device))
    if n % 2 == 1:
        left = idx * 2.0 / (n + 1)
        return torch.cat([left, left.flip(0)[1:]]).to(dtype)
    left = (2.0 * idx - 1.0) / n
    return torch.cat([left, left.flip(0)]).to(dtype)


def kaiser(n: int, *, beta: float = 12.0, periodic: bool = True, eps: float = 0.0,
           dtype=DEFAULT_FLOAT, device=None):
    """Kaiser window I0(beta sqrt(1 - r^2)) / I0(beta) over r in [-1, 1],
    in f64 with numpy's i0. `eps` floors the sqrt argument (the reference
    library's 1e-7); the default 0 is scipy's window.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import kaiser
    >>> kaiser(5, beta=12.0, periodic=False, device="cpu")
    tensor([5.2773e-05, 2.1567e-01, 1.0000e+00, 2.1567e-01, 5.2773e-05])
    """
    def build(length):
        ratio = np.linspace(-1.0, 1.0, length)
        return np.i0(beta * np.sqrt(np.maximum(1.0 - ratio * ratio, eps))) / np.i0(beta)
    return _host_window(n, periodic, dtype, device, build)


def general_hamming(n: int, alpha: float, *, periodic: bool = True, dtype=DEFAULT_FLOAT,
                    device=None):
    """Generalized Hamming window alpha - (1 - alpha) cos.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import general_hamming
    >>> general_hamming(6, 0.6, periodic=False, device="cpu").numpy().round(4)
    array([0.2   , 0.4764, 0.9236, 0.9236, 0.4764, 0.2   ], dtype=float32)
    """
    return general_cosine(n, [alpha, 1.0 - alpha], periodic=periodic, dtype=dtype,
                          device=device)


def blackmanharris(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """4-term Blackman-Harris window (-92 dB sidelobes).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import blackmanharris
    >>> blackmanharris(6, periodic=False, device="cpu").numpy().round(4)
    array([1.000e-04, 1.030e-01, 7.938e-01, 7.938e-01, 1.030e-01, 1.000e-04],
          dtype=float32)
    """
    return general_cosine(n, [0.35875, 0.48829, 0.14128, 0.01168], periodic=periodic,
                          dtype=dtype, device=device)


def nuttall(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Nuttall 4-term minimum-sidelobe window.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import nuttall
    >>> nuttall(6, periodic=False, device="cpu").numpy().round(4)
    array([4.000e-04, 1.105e-01, 7.983e-01, 7.983e-01, 1.105e-01, 4.000e-04],
          dtype=float32)
    """
    return general_cosine(n, [0.3635819, 0.4891775, 0.1365995, 0.0106411],
                          periodic=periodic, dtype=dtype, device=device)


def flattop(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Flat-top window, for amplitude-accurate spectral measurement.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import flattop
    >>> flattop(7, periodic=False, device="cpu").numpy().round(4)
    array([-4.000e-04, -5.130e-02,  1.982e-01,  1.000e+00,  1.982e-01,
           -5.130e-02, -4.000e-04], dtype=float32)
    """
    return general_cosine(
        n, [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368],
        periodic=periodic, dtype=dtype, device=device)


def bohman(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Bohman window (1 - |x|) cos(pi |x|) + sin(pi |x|) / pi.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import bohman
    >>> bohman(6, periodic=False, device="cpu").numpy().round(4)
    array([0.    , 0.1791, 0.8343, 0.8343, 0.1791, 0.    ], dtype=float32)
    """
    def build(length):
        fac = np.abs(np.linspace(-1.0, 1.0, length)[1:-1])
        w = (1.0 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
        return np.concatenate(([0.0], w, [0.0]))
    return _host_window(n, periodic, dtype, device, build)


def cosine(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Half-cycle sine window sin(pi (i + 1/2) / L).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import cosine
    >>> cosine(6, periodic=False, device="cpu").numpy().round(4)
    array([0.2588, 0.7071, 0.9659, 0.9659, 0.7071, 0.2588], dtype=float32)
    """
    return _host_window(n, periodic, dtype, device,
                        lambda length: np.sin(np.pi / length * (np.arange(length) + 0.5)))


def barthann(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Bartlett-Hann window.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import barthann
    >>> barthann(6, periodic=False, device="cpu").numpy().round(4)
    array([0.    , 0.3586, 0.8794, 0.8794, 0.3586, 0.    ], dtype=float32)
    """
    def build(length):
        fac = np.abs(np.arange(length) / (length - 1.0) - 0.5)
        return 0.62 - 0.48 * fac + 0.38 * np.cos(2.0 * np.pi * fac)
    return _host_window(n, periodic, dtype, device, build)


def parzen(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Parzen (de la Vallee Poussin) piecewise-cubic window.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import parzen
    >>> parzen(6, periodic=False, device="cpu").numpy().round(4)
    array([0.0093, 0.25  , 0.8611, 0.8611, 0.25  , 0.0093], dtype=float32)
    """
    def build(length):
        idx = np.arange(-(length - 1) / 2.0, (length - 1) / 2.0 + 0.5, 1.0)
        r = np.abs(idx) / (length / 2.0)
        return np.where(np.abs(idx) <= (length - 1) / 4.0,
                        1.0 - 6.0 * r**2 + 6.0 * r**3, 2.0 * (1.0 - r) ** 3)
    return _host_window(n, periodic, dtype, device, build)


def lanczos(n: int, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Lanczos (sinc) window sinc(2i / (L - 1) - 1).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import lanczos
    >>> lanczos(6, periodic=False, device="cpu").numpy().round(4)
    array([0.    , 0.5046, 0.9355, 0.9355, 0.5046, 0.    ], dtype=float32)
    """
    return _host_window(n, periodic, dtype, device,
                        lambda length: np.sinc(2.0 * np.arange(length) / (length - 1.0) - 1.0))


def gaussian(n: int, std: float, *, periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Gaussian window exp(-i^2 / (2 std^2)), centred.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import gaussian
    >>> gaussian(7, 1.5, periodic=False, device="cpu").numpy().round(4)
    array([0.1353, 0.4111, 0.8007, 1.    , 0.8007, 0.4111, 0.1353],
          dtype=float32)
    """
    def build(length):
        idx = np.arange(length) - (length - 1) / 2.0
        return np.exp(-(idx**2) / (2.0 * std * std))
    return _host_window(n, periodic, dtype, device, build)


def general_gaussian(n: int, p: float, sig: float, *, periodic: bool = True,
                     dtype=DEFAULT_FLOAT, device=None):
    """Generalized Gaussian window exp(-1/2 |i / sig|^(2p)).

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import general_gaussian
    >>> general_gaussian(7, 1.5, 2.0, periodic=False, device="cpu").numpy().round(4)
    array([0.185 , 0.6065, 0.9394, 1.    , 0.9394, 0.6065, 0.185 ],
          dtype=float32)
    """
    def build(length):
        idx = np.arange(length) - (length - 1) / 2.0
        return np.exp(-0.5 * np.abs(idx / sig) ** (2.0 * p))
    return _host_window(n, periodic, dtype, device, build)


def tukey(n: int, alpha: float = 0.5, *, periodic: bool = True, dtype=DEFAULT_FLOAT,
          device=None):
    """Tukey (tapered cosine) window: cosine tapers over alpha/2 of the
    span at each end, a flat middle.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import tukey
    >>> tukey(8, 0.5, periodic=False, device="cpu").numpy().round(4)
    array([0.    , 0.6113, 1.    , 1.    , 1.    , 1.    , 0.6113, 0.    ],
          dtype=float32)
    """
    def build(length):
        if alpha <= 0:
            return np.ones(length)
        if alpha >= 1.0:
            return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(length) / (length - 1.0)))
        idx = np.arange(length)
        width = int(np.floor(alpha * (length - 1) / 2.0))
        n1 = idx[: width + 1]
        n3 = idx[length - width - 1:]
        w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (length - 1))))
        w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * n3 / alpha / (length - 1))))
        return np.concatenate((w1, np.ones(length - 2 * width - 2), w3))
    return _host_window(n, periodic, dtype, device, build)


def exponential(n: int, center=None, tau: float = 1.0, *, periodic: bool = True,
                dtype=DEFAULT_FLOAT, device=None):
    """Exponential (Poisson) window exp(-|i - center| / tau); an explicit
    center needs the periodic form, as in scipy.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import exponential
    >>> exponential(6, tau=2.0, periodic=False, device="cpu").numpy().round(4)
    array([0.2865, 0.4724, 0.7788, 0.7788, 0.4724, 0.2865], dtype=float32)
    """
    if not periodic and center is not None:
        raise ValueError("If periodic is False, center must be None.")

    def build(length):
        c = (length - 1) / 2.0 if center is None else center
        return np.exp(-np.abs(np.arange(length) - c) / tau)
    return _host_window(n, periodic, dtype, device, build)


def taylor(n: int, nbar: int = 4, sll: float = 30.0, *, norm: bool = True,
           periodic: bool = True, dtype=DEFAULT_FLOAT, device=None):
    """Taylor window: near-constant sidelobes at -sll dB with nbar near-in
    sidelobes; its cosine-sum coefficients from the product formula.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import taylor
    >>> taylor(8, nbar=3, sll=20, periodic=False, device="cpu").numpy().round(4)
    array([0.5427, 0.6664, 0.848 , 0.981 , 0.981 , 0.848 , 0.6664, 0.5427],
          dtype=float32)
    """
    def build(length):
        big_b = 10.0 ** (sll / 20.0)
        big_a = np.arccosh(big_b) / np.pi
        s2 = nbar**2 / (big_a**2 + (nbar - 0.5) ** 2)
        ma = np.arange(1, nbar, dtype=np.float64)
        coefs = np.zeros(max(nbar - 1, 0))
        m2 = ma * ma
        for mi in range(len(ma)):
            numer = (-1.0) ** mi * np.prod(1.0 - m2[mi] / s2 / (big_a**2 + (ma - 0.5) ** 2))
            denom = 2.0 * np.prod(1.0 - m2[mi] / m2[:mi]) * np.prod(1.0 - m2[mi] / m2[mi + 1:])
            coefs[mi] = numer / denom

        def weight(pos):
            pos = np.atleast_1d(pos)
            return 1.0 + 2.0 * np.dot(coefs, np.cos(
                2.0 * np.pi * ma[:, None] * (pos[None, :] - length / 2.0 + 0.5) / length))

        w = weight(np.arange(length))
        return w / weight((length - 1) / 2.0) if norm else w
    return _host_window(n, periodic, dtype, device, build)


def chebwin(n: int, at: float = 100.0, *, periodic: bool = True, dtype=DEFAULT_FLOAT,
            device=None):
    """Dolph-Chebyshev window with `at` dB of equiripple sidelobe
    attenuation: the Chebyshev polynomial sampled in frequency, an inverse
    DFT, peak-normalized.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import chebwin
    >>> chebwin(7, 60, periodic=False, device="cpu").numpy().round(4)
    array([0.0871, 0.38  , 0.7947, 1.    , 0.7947, 0.38  , 0.0871],
          dtype=float32)
    """
    def build(length):
        order = length - 1
        beta = np.cosh(np.arccosh(10.0 ** (abs(at) / 20.0)) / order)
        x = beta * np.cos(np.pi * np.arange(length) / length)
        # T_order(x) on the three branches of |x| against 1
        p = np.zeros(length)
        gt, lt = x > 1, x < -1
        mid = ~gt & ~lt
        p[gt] = np.cosh(order * np.arccosh(x[gt]))
        p[lt] = (2 * (length % 2) - 1) * np.cosh(order * np.arccosh(-x[lt]))
        p[mid] = np.cos(order * np.arccos(x[mid]))
        if length % 2:
            w = np.real(np.fft.fft(p))
            half = (length + 1) // 2
            w = w[:half]
            w = np.concatenate((w[half - 1:0:-1], w))
        else:
            p = p * np.exp(1j * np.pi / length * np.arange(length))
            w = np.real(np.fft.fft(p))
            half = length // 2 + 1
            w = np.concatenate((w[half - 1:0:-1], w[1:half]))
        return w / np.max(w)
    return _host_window(n, periodic, dtype, device, build)


def dpss(n: int, half_bandwidth: float, n_windows=None, *, periodic: bool = False,
         dtype=DEFAULT_FLOAT, device=None):
    """Discrete prolate spheroidal (Slepian) sequences of unit energy,
    scipy.signal.windows.dpss(..., norm=2) semantics with its polarity
    conventions: (n,) when `n_windows` is None, else (n_windows, n). The
    eigenvectors of the symmetric tridiagonal DPSS operator, solved densely
    in f64 on the host.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import dpss
    >>> dpss(6, 1.5, periodic=False, device="cpu").numpy().round(4)
    array([0.1329, 0.3766, 0.5835, 0.5835, 0.3766, 0.1329], dtype=float32)
    """
    if not 0 < half_bandwidth < n / 2.0:
        raise ValueError("half_bandwidth must be in (0, n/2)")
    k_max = 1 if n_windows is None else int(n_windows)
    if not 0 < k_max <= n:
        raise ValueError(f"n_windows must be in [1, n], got {n_windows}")
    length = n + 1 if periodic else n
    frac = half_bandwidth / length
    t = np.arange(length, dtype=np.float64)
    diag = ((length - 1 - 2.0 * t) / 2.0) ** 2 * np.cos(2.0 * np.pi * frac)
    off = t[1:] * (length - t[1:]) / 2.0
    mat = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    _, vecs = np.linalg.eigh(mat)
    wins = vecs[:, ::-1][:, :k_max].T.copy()  # (k_max, length), unit norm
    fix_even = wins[::2].sum(axis=1) < 0
    wins[::2][fix_even] *= -1
    thresh = max(1e-7, 1.0 / length)
    for i, w in enumerate(wins[1::2]):
        sig = w[w * w > thresh**2]
        if sig.size and sig[0] < 0:
            wins[2 * i + 1] *= -1
    out = torch.as_tensor(wins[:, :n], device=target_device(device)).to(dtype)
    return out[0] if n_windows is None else out


def kaiser_bessel_derived(n: int, beta: float, *, dtype=DEFAULT_FLOAT, device=None):
    """Kaiser-Bessel derived (KBD) window, the MDCT window satisfying the
    Princen-Bradley condition: w[k] = sqrt(cumsum(kaiser)[k] / sum(kaiser))
    of an (n/2 + 1)-point Kaiser window for the first half, mirrored. Even n
    only, as in scipy; f64 on the host.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import kaiser_bessel_derived
    >>> kaiser_bessel_derived(4, beta=4.0, device="cpu").numpy().round(4)
    array([0.2742, 0.9617, 0.9617, 0.2742], dtype=float32)
    """
    if n < 0:
        raise ValueError("Window length n must be non-negative")
    if n % 2:
        raise ValueError("Kaiser-Bessel Derived windows are only defined "
                         "for even number of points")
    device = target_device(device)
    if n == 0:
        return torch.zeros((0,), dtype=dtype, device=device)
    kw = kaiser(n // 2 + 1, beta=float(beta), periodic=False, dtype=torch.float64,
                device="cpu").numpy()
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return torch.as_tensor(np.concatenate([half, half[::-1]]), device=device).to(dtype)


def boxcar(n: int, *, dtype=DEFAULT_FLOAT, device=None):
    """The rectangular window under scipy's name, float by default.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import boxcar
    >>> boxcar(3, device="cpu")
    tensor([1., 1., 1.])
    """
    return torch.ones((n,), dtype=dtype, device=target_device(device))


def triang(n: int, *, dtype=DEFAULT_FLOAT, device=None):
    """The triangular window under scipy's name (non-zero endpoints,
    unlike bartlett), always symmetric.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import triang
    >>> triang(4, device="cpu").numpy().round(4)
    array([0.25, 0.75, 0.75, 0.25], dtype=float32)
    """
    return triangular(n, dtype=dtype, device=device)


def _no_periodic(fn):
    """A builder of (n, periodic, dtype, device) for a window that has one
    form only."""
    return lambda n, periodic, dtype, device: fn(n, dtype=dtype, device=device)


def _either(fn):
    return lambda n, periodic, dtype, device: fn(n, periodic=periodic, dtype=dtype,
                                                 device=device)


_WINDOW_BUILDERS = {
    "rectangular": _no_periodic(rectangular),
    "boxcar": _no_periodic(rectangular),  # scipy.signal.get_window's name for it
    "triang": _no_periodic(triangular),
    "bartlett": _no_periodic(bartlett),
    "triangular": _no_periodic(triangular),
    **{name: _either(fn) for name, fn in (
        ("blackman", blackman), ("hamming", hamming), ("hann", hann),
        ("blackmanharris", blackmanharris), ("nuttall", nuttall), ("flattop", flattop),
        ("bohman", bohman), ("cosine", cosine), ("barthann", barthann), ("parzen", parzen),
        ("lanczos", lanczos), ("tukey", tukey), ("exponential", exponential),
        ("taylor", taylor), ("chebwin", chebwin))},
}

# windows whose spec carries positional parameters: name -> constructor of
# (n, *params, periodic=..., dtype=..., device=...)
_PARAMETRIC_WINDOWS = {
    "kaiser_bessel_derived": lambda n, beta, periodic=False, dtype=None, device=None:
        kaiser_bessel_derived(n, beta, dtype=DEFAULT_FLOAT if dtype is None else dtype,
                              device=device),
    "gaussian": gaussian,
    "general_gaussian": general_gaussian,
    "general_cosine": general_cosine,
    "general_hamming": general_hamming,
    "tukey": tukey,
    "exponential": exponential,
    "taylor": taylor,
    "chebwin": chebwin,
    "dpss": dpss,
}


def _unknown_window(window):
    return ValueError(
        f"unknown window {window!r}, supported: "
        f"{sorted(set(_WINDOW_BUILDERS) | set(_PARAMETRIC_WINDOWS))} "
        "or (name, *params) with name in "
        f"{sorted(set(_PARAMETRIC_WINDOWS) | {'kaiser'})}")


def get_window(window, n: int, *, periodic: bool = False, dtype=DEFAULT_FLOAT, device=None):
    """Build a window from a spec: a name, or a (name, *params) tuple such
    as ('kaiser', beta), ('gaussian', std), ('tukey', alpha), ('chebwin',
    attenuation_db) or ('dpss', half_bandwidth). Symmetric by default, as
    filter design requires; spectral analysis asks for periodic=True. The
    names, defaults and error messages are the JAX package's.

    Examples:

    >>> from nx_signal_tpu_torch.ops.windows import get_window
    >>> get_window("hann", 4, device="cpu").numpy().round(4)
    array([0.  , 0.75, 0.75, 0.  ], dtype=float32)
    >>> get_window(("kaiser", 8.0), 5, device="cpu").numpy().round(4)
    array([0.0023, 0.369 , 1.    , 0.369 , 0.0023], dtype=float32)
    """
    if isinstance(window, (tuple, list)):
        name, *params = window
        if name == "kaiser":
            (beta,) = params
            return kaiser(n, beta=beta, periodic=periodic, dtype=dtype, device=device)
        if name in _PARAMETRIC_WINDOWS:
            return _PARAMETRIC_WINDOWS[name](n, *params, periodic=periodic, dtype=dtype,
                                             device=device)
        raise _unknown_window(window)
    if window not in _WINDOW_BUILDERS:
        raise _unknown_window(window)
    if window in ("rectangular", "boxcar"):
        return boxcar(n, dtype=dtype, device=device)
    return _WINDOW_BUILDERS[window](n, periodic, dtype, device)
