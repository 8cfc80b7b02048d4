"""Short-Time Fourier Transform: stft / istft / fft_frequencies
(counterpart of nx_signal_tpu/spectral/stft.py).

The port decides the route of the framed DFT here and nowhere else:
`_framed_spectrum` (forward: `kernels.dft.framed_dft` where
`kernels.cuda_dft._auto_takes_kernel` sends a real signal, torch.fft
otherwise) and `_windowed_frames` (inverse: `kernels.dft.framed_idft` or
torch.fft). `stft`, `istft`, the sharded and streaming STFTs and the
filtered `stft_fir_chain` share them; `ShortTimeFFT` keeps its own rule.
The overlap-add is `spectral.framing._ola_fold` (kernel C on a CUDA
tensor). torch.stft / torch.istft are not used: their centering, padding
and layout differ from this package's. Leading batch axes (channels) are
supported everywhere.
"""

from typing import NamedTuple

import numpy as np
import torch

from nx_signal_tpu_torch.kernels.cuda_dft import _auto_takes_kernel
from nx_signal_tpu_torch.kernels.dft import framed_dft, framed_idft, good_matmul_fft_length
from nx_signal_tpu_torch.spectral.framing import _ola_fold, pad_for_windowing
from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.profiling import span
from nx_signal_tpu_torch.utils.shapes import next_power_of_two

__all__ = ["stft", "istft", "fft_frequencies", "STFTResult", "check_cola", "check_nola",
           "check_COLA", "check_NOLA"]


class STFTResult(NamedTuple):
    """STFT output: complex spectrum [..., frames, frequencies], frame times
    in seconds, and FFT bin frequencies in Hz."""

    z: torch.Tensor
    times: torch.Tensor
    frequencies: torch.Tensor


def fft_frequencies(sampling_rate, *, fft_length: int, dtype=DEFAULT_FLOAT,
                    endpoint: bool = False, device=None):
    """FFT bin frequencies in Hz: linspace(0, Fs, fft_length, endpoint=False),
    the full bin range, on `device` (None: the card).

    Examples:

    >>> from nx_signal_tpu_torch.spectral.stft import fft_frequencies
    >>> fft_frequencies(sampling_rate=10.0, fft_length=5, device="cpu")
    tensor([0., 2., 4., 6., 8.])
    """
    device = target_device(device)
    if endpoint:
        return _linspace(0.0, sampling_rate, fft_length, dtype=dtype, device=device)
    return _linspace(0.0, sampling_rate, fft_length + 1, dtype=dtype, device=device)[:-1]


def _linspace(start, stop, num: int, *, dtype=DEFAULT_FLOAT, device):
    """`num` evenly spaced values from start to stop, each formed as start +
    i * step in `dtype` (jax.numpy.linspace's rounding; torch.linspace
    rounds some points differently)."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    step = (stop - start) / (num - 1)
    return start + torch.arange(num, dtype=dtype, device=device) * step


def _resolve_fft_length(frame_length: int, fft_length) -> int:
    if fft_length is None or fft_length == "power_of_two":
        return next_power_of_two(frame_length)
    return int(fft_length)


def _apply_scaling(z, window, scaling, sampling_rate, inverse: bool):
    """'spectrum' divides by sum(w); 'psd' by sqrt(Fs * sum(w^2)); the
    inverse multiplies back."""
    if scaling is None:
        return z
    if not (window.dtype.is_floating_point or window.dtype.is_complex):
        window = window.to(DEFAULT_FLOAT)
    if scaling == "spectrum":
        factor = torch.sum(window)
    elif scaling == "psd":
        if sampling_rate is None:
            raise ValueError("sampling_rate is mandatory if scaling is 'psd'")
        factor = torch.sqrt(sampling_rate * torch.sum(window ** 2))
    else:
        raise ValueError(
            f"invalid scaling, expected one of 'spectrum', 'psd' or None, got: {scaling}"
        )
    return z * factor if inverse else z / factor


def stft(data, window, *, sampling_rate=100, fft_length="power_of_two",
         overlap_length=None, window_padding="valid", scaling=None,
         onesided=False, method="auto", precision="highest"):
    """Short-Time Fourier Transform of the (..., L) signal: frames with hop
    frame_length - overlap_length, multiplies by `window` and transforms
    each frame. Returns `STFTResult(z, times, frequencies)` with z complex
    (..., frames, fft_length), or (..., frames, fft_length//2 + 1) with
    `onesided=True`; frame times are window midpoints time_step*(1..M),
    time_step = frame_length / (2 Fs).

    Defaults: sampling_rate 100, fft_length 'power_of_two' (next power of
    two >= frame_length), overlap_length frame_length//2, window_padding
    'valid' ('same', 'reflect' or (lo, hi) also work), scaling None,
    'spectrum' or 'psd'.

    `method`: 'auto' takes the route of `_framed_spectrum` (the framed-DFT
    kernels for real input with frame_length <= fft_length within the
    device's cut, `kernels.cuda_dft._auto_takes_kernel`; torch.fft
    otherwise); 'fft' and 'matmul' force a path. `precision` is accepted
    for the JAX package's signature; the framed DFT runs f32 at every
    setting.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.spectral.stft import stft
    >>> x = torch.sin(2 * torch.pi * 100.0 * torch.arange(400) / 400.0)
    >>> z, times, freqs = stft(x, hann(64, device="cpu"), sampling_rate=400.0, overlap_length=32)
    >>> z.shape, float(freqs[16]), int(z[0].abs().argmax())
    (torch.Size([11, 64]), 100.0, 16)
    """
    with span("nx.stft"):
        data = as_signal(data)
        window = torch.as_tensor(window, device=data.device)
        (frame_length,) = window.shape
        if overlap_length is None:
            overlap_length = frame_length // 2
        if sampling_rate is None:
            raise ValueError("missing sampling_rate option")
        n_fft = _resolve_fft_length(frame_length, fft_length)
        if not 0 <= overlap_length < frame_length:
            raise ValueError(
                "overlap_length must satisfy 0 <= overlap_length < frame_length "
                f"(got overlap {overlap_length} for frame {frame_length})"
            )
        stride = frame_length - overlap_length

        if method not in ("auto", "fft", "matmul"):
            raise ValueError(
                f"invalid method, expected one of 'auto', 'fft', 'matmul', got: {method}"
            )
        padded = pad_for_windowing(data, frame_length, window_padding)
        spectrum = _framed_spectrum(padded, window, stride=stride, n_fft=n_fft,
                                    onesided=onesided, method=method, precision=precision)
        return _stft_result(spectrum, window, n_fft=n_fft, onesided=onesided, scaling=scaling,
                            sampling_rate=sampling_rate, num_frames=spectrum.shape[-2])


def _framed_spectrum(x, window, *, stride: int, n_fft: int, onesided: bool, method,
                     precision, output: str = "complex"):
    """The framed DFT of the (..., L) signal, already padded or
    halo-extended: frame m is x[m*stride : m*stride + frame_length] times
    `window`, transformed at n_fft (zero-padded, or cut as torch.fft's `n`
    cuts), (..., frames, bins) complex, or its |z|^2 with
    `output='power'`.

    The port's one route rule for it: method='matmul', and method='auto' on
    a real signal with n_fft >= frame_length where
    `kernels.cuda_dft._auto_takes_kernel` sends it, run
    `kernels.dft.framed_dft`; anything else runs torch.fft on the frames.
    `method` is not validated here (`stft` checks it)."""
    frame_length = window.shape[-1]
    real_input = not x.is_complex()
    use_matmul = method == "matmul" or (
        method == "auto" and real_input and _auto_takes_kernel(x, n_fft)
        and n_fft >= frame_length  # the contraction zero-pads; it cannot truncate
    )
    if use_matmul and not real_input:
        raise ValueError("method='matmul' requires real input")
    if use_matmul and n_fft < frame_length:
        raise ValueError(
            "method='matmul' requires fft_length >= frame_length "
            f"(got {n_fft} < {frame_length}); use method='fft'"
        )
    if stride < 1:
        raise ValueError(f"expected an integer >= 1 for stride, got: {stride}")
    if x.shape[-1] < frame_length:
        raise ValueError(
            f"window length {frame_length} exceeds padded signal length {x.shape[-1]}"
        )
    if use_matmul:
        return framed_dft(x, window, stride=stride, n_fft=n_fft, onesided=onesided,
                          precision=precision, output=output)
    fft = torch.fft.rfft if onesided else torch.fft.fft
    z = fft(x.unfold(-1, frame_length, stride) * window, n=n_fft, dim=-1)
    return z.abs() ** 2 if output == "power" else z


def _stft_result(z, window, *, n_fft: int, onesided: bool, scaling, sampling_rate,
                 num_frames: int):
    """The STFTResult of the spectrum z: z scaled, `num_frames` frame
    times (window midpoints) and the bins' frequencies, on z's device."""
    frequencies = fft_frequencies(sampling_rate, fft_length=n_fft, device=z.device)
    if onesided:
        frequencies = frequencies[: n_fft // 2 + 1]
    time_step = window.shape[-1] / (2.0 * sampling_rate)
    times = torch.linspace(time_step, time_step * num_frames, num_frames,
                           dtype=DEFAULT_FLOAT, device=z.device)
    z = _apply_scaling(z, window, scaling, sampling_rate, inverse=False)
    return STFTResult(z, times, frequencies)


def istft(z, window, *, fft_length=None, overlap_length=None, scaling=None,
          sampling_rate=1000, onesided=False, method="auto", precision="highest"):
    """Inverse STFT: per-frame inverse DFT, inverse scaling, synthesis-window
    multiply, deterministic overlap-add, and the window-envelope (NOLA)
    normalization with a 1e-10 guard. Returns the complex reconstruction,
    or a real one for a onesided spectrum (`onesided=True`).

    `method`: 'auto' takes the route of `_windowed_frames`
    (`kernels.dft.framed_idft`, the inverse DFT with the window fused in,
    for fft_length <= 1024 when the window spans fft_length; torch.fft
    otherwise); 'fft' and 'matmul' force a path.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.spectral.stft import istft, stft
    >>> x = torch.sin(torch.arange(256) / 5.0)
    >>> z, _, _ = stft(x, hann(32, device="cpu"), overlap_length=16)
    >>> y = istft(z, hann(32, device="cpu"), overlap_length=16)
    >>> bool((y.real[16:-16] - x[16:y.shape[-1] - 16]).abs().max() < 1e-6)
    True
    """
    with span("nx.istft"):
        z = as_signal(z)
        window = torch.as_tensor(window, device=z.device)
        if onesided and fft_length is None:
            n_fft = 2 * (z.shape[-1] - 1)
        else:
            n_fft = _resolve_fft_length(z.shape[-1], fft_length)
        if overlap_length is None:
            overlap_length = window.shape[-1] // 2
        if method not in ("auto", "fft", "matmul"):
            raise ValueError(
                f"invalid method, expected one of 'auto', 'fft', 'matmul', got: {method}"
            )
        windowed = _windowed_frames(z, window, n_fft=n_fft, onesided=onesided, method=method,
                                    scaling=scaling, sampling_rate=sampling_rate,
                                    precision=precision)
        num_frames, frame_length = windowed.shape[-2], windowed.shape[-1]
        if overlap_length >= frame_length:
            raise ValueError(
                f"overlap_length must be a number less than the window size {frame_length}, "
                f"got: {overlap_length}"
            )
        stride = frame_length - overlap_length
        out_length = num_frames * stride + overlap_length

        result = _ola_fold(windowed, stride, out_length)
        envelope = (window.abs().to(DEFAULT_FLOAT) ** 2).expand(num_frames, frame_length)
        norm = _ola_fold(envelope, stride, out_length)
        norm = torch.where(norm > 1e-10, norm, torch.ones((), dtype=norm.dtype, device=norm.device))
        return result / norm


def _windowed_frames(z, window, *, n_fft: int, onesided: bool, method, scaling,
                     sampling_rate, precision):
    """The (..., M, bins) spectrum z as synthesis-windowed time frames:
    each frame's inverse DFT at n_fft, the inverse scaling, times `window`.
    The port's one route rule for it: method='matmul', and method='auto'
    where the JAX package puts it (`kernels.dft.good_matmul_fft_length`)
    with a window of n_fft samples, run `kernels.dft.framed_idft` (the
    window fused in); anything else runs torch.fft, whose frames the window
    broadcasts over."""
    if method == "matmul" or (
        method == "auto" and good_matmul_fft_length(n_fft)
        and window.shape[-1] == n_fft  # the fft path broadcasts the window
    ):
        # scaling is a scalar multiply and commutes with the linear transform
        frames = framed_idft(z, window, n_fft=n_fft, onesided=onesided, precision=precision)
        return _apply_scaling(frames, window, scaling, sampling_rate, inverse=True)
    ifft = torch.fft.irfft if onesided else torch.fft.ifft
    frames = _apply_scaling(ifft(z, n=n_fft, dim=-1), window, scaling, sampling_rate,
                            inverse=True)
    return frames * window


def _check_window_arg(window, nperseg: int):
    """The window as a host f64 array. A name (or a ('general_cosine',
    coefs) tuple) resolves, as scipy's get_window does by default, to the
    PERIODIC window in f64: the f32 hann's COLA deviation (~6e-8) would
    fail the 1e-10 default tolerance."""
    if isinstance(window, (str, tuple)):
        from nx_signal_tpu_torch.ops.windows import get_window

        w = get_window(window, nperseg, periodic=True, dtype=torch.float64,
                       device="cpu").numpy()
    else:
        if isinstance(window, torch.Tensor):
            window = window.detach().cpu().numpy()
        w = np.asarray(window, dtype=np.float64)
    if w.ndim != 1:
        raise ValueError("window must be 1-D")
    if w.shape[0] != nperseg:
        raise ValueError("window must have length of nperseg")
    return w


def check_cola(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Whether the window and hop satisfy the Constant OverLap-Add
    constraint, scipy.signal.check_COLA's contract: the strided sums
    sum_j w[k + j*step] are equal (within `tol`) for every k of one hop.
    Host-side f64; `window` is an array or a window name.

    Examples:

    >>> from nx_signal_tpu_torch.spectral.stft import check_cola
    >>> check_cola("hann", 8, 4), check_cola("hann", 8, 3)
    (True, False)
    """
    w = _check_window_arg(window, nperseg)
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    step = nperseg - noverlap
    binsums = np.sum([w[i * step:(i + 1) * step] for i in range(nperseg // step)], axis=0)
    if nperseg % step != 0:
        binsums[:nperseg % step] += w[-(nperseg % step):]
    deviation = binsums - np.median(binsums)
    return bool(np.max(np.abs(deviation)) < tol)


def check_nola(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Whether the window and hop satisfy the NOnzero OverLap-Add
    constraint, scipy.signal.check_NOLA's contract: min_k sum_j
    |w[k + j*step]|^2 > tol, the guard `istft` applies per sample.

    Examples:

    >>> from nx_signal_tpu_torch.spectral.stft import check_nola
    >>> check_nola("hann", 8, 4), check_nola("hann", 8, 0)
    (True, False)
    """
    w = _check_window_arg(window, nperseg)
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if tol <= 0:
        raise ValueError("tol must be positive")
    step = nperseg - noverlap
    binsums = np.sum([w[i * step:(i + 1) * step] ** 2 for i in range(nperseg // step)],
                     axis=0)
    if nperseg % step != 0:
        binsums[:nperseg % step] += w[-(nperseg % step):] ** 2
    return bool(np.min(binsums) > tol)


# scipy.signal spells these with upper-case acronyms
check_COLA = check_cola
check_NOLA = check_nola
