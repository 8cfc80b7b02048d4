"""Short-Time Fourier Transform: stft / istft / fft_frequencies
(counterpart of nx_signal_tpu/spectral/stft.py).

The forward transform runs the fused framing + window + DFT
(kernels/dft.py:framed_dft: on a CUDA tensor the CUDA kernel B-fft, an FFT
per frame, at every fft_length from 8 to 1024, and the dense kernel B for a
shorter one) for real input with fft_length <= 1024, and torch.fft on
explicit frames otherwise.
The inverse runs the fused inverse-DFT + synthesis-window matmul
(kernels/dft.py:framed_idft) and the deterministic overlap-add
(spectral/framing.py:_ola_fold, the CUDA kernel C on a CUDA tensor).
torch.stft / torch.istft are not used: their centering, padding and layout
differ from this package's. Leading batch axes (channels) are supported
everywhere.
"""

from typing import NamedTuple

import numpy as np
import torch

from nx_signal_tpu_torch.kernels.cuda_dft import _auto_takes_kernel
from nx_signal_tpu_torch.kernels.dft import framed_dft, framed_idft, good_matmul_fft_length
from nx_signal_tpu_torch.spectral.framing import _ola_fold, as_windowed, pad_for_windowing
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

    `method`: 'auto' uses the framed-DFT contraction for real input with
    frame_length <= fft_length <= 1024 and torch.fft otherwise; 'fft' and
    'matmul' force a path. `precision` is accepted for the JAX package's
    signature; the framed DFT runs f32 at every setting.

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
        real_input = not data.is_complex()
        use_matmul = method == "matmul" or (
            method == "auto" and real_input and _auto_takes_kernel(data, n_fft)
            and n_fft >= frame_length  # the contraction zero-pads; it cannot truncate
        )
        if use_matmul and not real_input:
            raise ValueError("method='matmul' requires real input")
        if use_matmul and n_fft < frame_length:
            raise ValueError(
                "method='matmul' requires fft_length >= frame_length "
                f"(got {n_fft} < {frame_length}); use method='fft'"
            )

        if use_matmul:
            padded = pad_for_windowing(data, frame_length, window_padding)
            if padded.shape[-1] < frame_length:
                raise ValueError(
                    f"window length {frame_length} exceeds padded signal length "
                    f"{padded.shape[-1]}"
                )
            spectrum = framed_dft(padded, window, stride=stride, n_fft=n_fft,
                                  onesided=onesided, precision=precision)
        else:
            frames = as_windowed(data, window_length=frame_length, stride=stride,
                                 padding=window_padding)
            fft = torch.fft.rfft if onesided else torch.fft.fft
            spectrum = fft(frames * window, n=n_fft, dim=-1)
        num_frames = spectrum.shape[-2]

        frequencies = fft_frequencies(sampling_rate, fft_length=n_fft, device=data.device)
        if onesided:
            frequencies = frequencies[: n_fft // 2 + 1]
        time_step = frame_length / (2.0 * sampling_rate)
        times = torch.linspace(time_step, time_step * num_frames, num_frames,
                               dtype=DEFAULT_FLOAT, device=data.device)
        spectrum = _apply_scaling(spectrum, window, scaling, sampling_rate, inverse=False)
        return STFTResult(spectrum, times, frequencies)


def istft(z, window, *, fft_length=None, overlap_length=None, scaling=None,
          sampling_rate=1000, onesided=False, method="auto", precision="highest"):
    """Inverse STFT: per-frame inverse DFT, inverse scaling, synthesis-window
    multiply, deterministic overlap-add, and the window-envelope (NOLA)
    normalization with a 1e-10 guard. Returns the complex reconstruction,
    or a real one for a onesided spectrum (`onesided=True`).

    `method`: 'auto' uses the fused inverse-DFT + window matmul for
    fft_length <= 1024 when the window spans fft_length, torch.fft
    otherwise.

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
        use_matmul = method == "matmul" or (
            method == "auto" and good_matmul_fft_length(n_fft)
            and window.shape[-1] == n_fft  # the fft path broadcasts the window
        )

        if use_matmul:
            # scaling is a scalar multiply and commutes with the linear transform
            windowed = framed_idft(z, window, n_fft=n_fft, onesided=onesided,
                                   precision=precision)
            windowed = _apply_scaling(windowed, window, scaling, sampling_rate, inverse=True)
        else:
            ifft = torch.fft.irfft if onesided else torch.fft.ifft
            frames = ifft(z, n=n_fft, dim=-1)
            frames = _apply_scaling(frames, window, scaling, sampling_rate, inverse=True)
            windowed = frames * window
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
