"""Convolution and correlation with scipy.signal's conventions (counterpart
of nx_signal_tpu/ops/convolution.py).

* A direct 1-D FIR convolution (a kernel whose leading axes are all 1) is
  the blocked Toeplitz contraction `fir_convolve_1d`, one conv1d through
  `kernels.dft.blocked_frame_matmul`.
* Other direct convolutions are torch conv1d / conv2d / conv3d (rank 4 and
  up is a sum of rank-3 ones) after zero padding. Those functions correlate,
  so the kernel is flipped; complex operands split into four real
  convolutions.
* `fftconvolve` pads each convolved axis to the next power of two and
  slices back to N + K - 1; real operands take the rfft half spectrum.
* `oaconvolve` adds its blocks with the left fold `spectral.framing._ola_fold`
  (kernel C on a CUDA tensor), never a scatter-add, so each output sample
  sums its blocks in increasing block order.

Every direct convolution runs exact f32 (TF32 off on CUDA).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.kernels.dft import _exact_f32, blocked_frame_matmul
from nx_signal_tpu_torch.ops.iir import lfilter
from nx_signal_tpu_torch.ops.transforms import fft_nd, ifft_nd, irfft_nd, rfft_nd
from nx_signal_tpu_torch.spectral.framing import _ola_fold
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import default_complex, result_real_dtype
from nx_signal_tpu_torch.utils.shapes import fft_fast_length

__all__ = ["convolve", "correlate", "correlation_lags", "deconvolve", "choose_conv_method",
           "fftconvolve", "oaconvolve", "fir_convolve_1d", "convolve2d", "correlate2d"]

_MODES = ("full", "same", "valid")
_BOUNDARIES = {"fill": "constant", "wrap": "wrap", "symm": "symmetric"}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _check_mode(mode):
    if mode not in _MODES:
        raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")


def _check_mode_method(mode, method):
    _check_mode(mode)
    if method not in ("direct", "fft"):
        raise ValueError(f"expected method to be one of ['direct', 'fft'], got: {method}")


def _operands(in1, in2):
    """Both operands as tensors on the first one's device."""
    in1 = as_signal(in1)
    return in1, torch.as_tensor(in2, device=in1.device)


def convolve(in1, in2, *, mode="full", method="direct"):
    """Convolution of two tensors; `method` 'direct' or 'fft'. Modes:
    'full' -> N+K-1 samples, 'same' -> the centre N, 'valid' -> the centre
    N-K+1.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import convolve
    >>> convolve(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 0.5]))
    tensor([0.0000, 1.0000, 2.5000, 4.0000, 1.5000])
    >>> convolve(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 0.5]), mode="same")
    tensor([1.0000, 2.5000, 4.0000])
    """
    _check_mode_method(mode, method)
    if method == "direct":
        return _direct_convolve(in1, in2, mode)
    return fftconvolve(in1, in2, mode=mode)


def correlate(in1, in2, *, mode="full", method="direct"):
    """Cross-correlation: convolution with the reversed (and, if complex,
    conjugated) kernel.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import correlate
    >>> correlate(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 0.5]))
    tensor([0.5000, 2.0000, 3.5000, 3.0000, 0.0000])
    """
    in1, in2 = _operands(in1, in2)
    kernel = in2.flip(tuple(range(in2.ndim)))
    if kernel.is_complex():
        kernel = kernel.conj()
    return convolve(in1, kernel, mode=mode, method=method)


def _boundary_pad(x, p: int, q: int, boundary: str, fillvalue):
    """Pad a 2-D tensor by the kernel overhang (p-1, q-1) on every side, as
    numpy's 'constant' (with `fillvalue`), 'wrap' or 'symmetric' modes."""
    m, n = x.shape
    if boundary == "fill":
        out = torch.full((m + 2 * (p - 1), n + 2 * (q - 1)), fillvalue, dtype=x.dtype,
                         device=x.device)
        out[p - 1:p - 1 + m, q - 1:q - 1 + n] = x
        return out
    mode = _BOUNDARIES[boundary]
    rows = torch.as_tensor(np.pad(np.arange(m), (p - 1, p - 1), mode=mode), device=x.device)
    cols = torch.as_tensor(np.pad(np.arange(n), (q - 1, q - 1), mode=mode), device=x.device)
    return x[rows][:, cols]


def convolve2d(in1, in2, *, mode="full", boundary="fill", fillvalue=0):
    """2-D convolution with scipy.signal.convolve2d's boundary handling:
    'fill' (pad with `fillvalue`), 'wrap' (circular) or 'symm' (symmetric
    reflection including the edge sample), as boundary padding by the
    kernel overhang, a 'valid' convolution and scipy's mode slices.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import convolve2d
    >>> convolve2d(torch.ones((3, 3)), torch.ones((2, 2)), mode="valid")
    tensor([[4., 4.],
            [4., 4.]])
    """
    _check_mode_method(mode, "direct")
    if boundary not in _BOUNDARIES:
        raise ValueError(
            f"expected boundary to be one of ['fill', 'wrap', 'symm'], got: {boundary}")
    in1, in2 = _operands(in1, in2)
    if in1.ndim != 2 or in2.ndim != 2:
        raise ValueError("convolve2d inputs must both be rank 2")
    m, n = in1.shape
    p, q = in2.shape
    if mode == "valid" and (m - p) * (n - q) < 0:
        raise ValueError(
            "For 'valid' mode, one must be at least as large as the other in every dimension")
    if mode == "valid" and (m < p or n < q):
        in1, in2 = in2, in1
        m, n, p, q = p, q, m, n

    if boundary == "fill" and fillvalue == 0:
        full = convolve(in1, in2, mode="full")
    else:
        full = convolve(_boundary_pad(in1, p, q, boundary, fillvalue), in2, mode="valid")
    if mode == "full":
        return full
    if mode == "same":
        r0, c0 = (p - 1) // 2, (q - 1) // 2
        return full[r0:r0 + m, c0:c0 + n]
    return full[p - 1:m, q - 1:n]


def correlate2d(in1, in2, *, mode="full", boundary="fill", fillvalue=0):
    """2-D cross-correlation with scipy.signal.correlate2d's boundary
    handling: the full convolution with the flipped (conjugated, if
    complex) kernel, with correlation's own 'same' anchor (index k//2 of
    the kernel). Where 'valid' needs the operands swapped, the swapped
    result is reversed but not conjugated, as scipy does.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import correlate2d
    >>> correlate2d(torch.ones((3, 3)), torch.ones((2, 2)), mode="valid")
    tensor([[4., 4.],
            [4., 4.]])
    """
    _check_mode_method(mode, "direct")
    in1, in2 = _operands(in1, in2)
    if in1.ndim != 2 or in2.ndim != 2:
        raise ValueError("correlate2d inputs must both be rank 2")
    m, n = in1.shape
    p, q = in2.shape
    if mode == "valid" and (m < p or n < q):
        swapped = correlate2d(in2, in1, mode=mode, boundary=boundary, fillvalue=fillvalue)
        return swapped.flip((0, 1))
    kernel = in2.flip((0, 1))
    if kernel.is_complex():
        kernel = kernel.conj()
    full = convolve2d(in1, kernel, mode="full", boundary=boundary, fillvalue=fillvalue)
    if mode == "full":
        return full
    if mode == "same":
        r0, c0 = p // 2, q // 2
        return full[r0:r0 + m, c0:c0 + n]
    return full[p - 1:m, q - 1:n]


def _float_cast(x):
    """Promote to the float / complex compute dtype: integers and narrow
    floats to float32 (complex64), float64 stays float64."""
    real = result_real_dtype(x.dtype)
    return x.to(default_complex(real) if x.is_complex() else real)


def _check_ranks(in1, in2):
    r1, r2 = in1.ndim, in2.ndim
    if r1 == r2:
        return r1
    if r1 == 0:
        raise ValueError(f"Incompatible ranks: {{0, {r2}}}")
    if r2 == 0:
        raise ValueError(f"Incompatible ranks: {{{r1}, 0}}")
    raise ValueError("convolve requires both inputs to have the same rank or one of them "
                     f"to be a scalar, got {r1} and {r2}")


def _valid_swap(in1, in2):
    """'valid' needs one operand at least as large as the other on every
    axis; put that one first."""
    if all(a >= b for a, b in zip(in1.shape, in2.shape)):
        return in1, in2
    if all(a <= b for a, b in zip(in1.shape, in2.shape)):
        return in2, in1
    raise ValueError(
        "For 'valid' mode, one must be at least as large as the other in every dimension")


def _corr_valid(volume, kernel):
    """Real 'valid' N-D cross-correlation of one volume with one kernel:
    conv1d / conv2d / conv3d, and for rank > 3 a sum over the kernel's
    first axis of rank-(N-1) correlations."""
    rank = kernel.ndim
    if rank <= 3:
        with _exact_f32():
            return _CONV[rank](volume[None, None], kernel[None, None])[0, 0]
    n0 = volume.shape[0] - kernel.shape[0] + 1
    out = None
    for i in range(kernel.shape[0]):
        term = torch.stack([_corr_valid(volume[i + o], kernel[i]) for o in range(n0)])
        out = term if out is None else out + term
    return out


def _conv_real(volume, kernel, padding):
    """Real N-D correlation of `volume` zero-padded by `padding` [(lo, hi)
    per axis] with the (already flipped) `kernel`."""
    pad = [p for lo_hi in reversed(padding) for p in lo_hi]
    if any(pad):
        volume = F.pad(volume, pad)
    return _corr_valid(volume, kernel)


def _fir_block_size(k: int) -> int:
    """Output-block width of the Toeplitz FIR path: at least K, so the work
    wasted on the band's corners, (B + K - 1)/B, stays <= 2."""
    return max(512, -(-k // 128) * 128)


def _toeplitz_band_on(taps, block: int):
    """`kernels.dft.toeplitz_band(taps, block)` gathered from the 1-D taps
    tensor where it lies: taps already on the card (a streaming FIR's)
    cost no host-to-device copy."""
    k = taps.shape[0]
    t = torch.arange(block + k - 1, device=taps.device)[:, None]
    j = torch.arange(block, device=taps.device)[None, :]
    m = j + (k - 1) - t
    zero = torch.zeros((), dtype=taps.dtype, device=taps.device)
    return torch.where((m >= 0) & (m < k), taps[m.clamp(0, k - 1)], zero)


def fir_convolve_1d(x, taps, mode="full", *, origin: int = 0):
    """1-D convolution over the last axis as a blocked Toeplitz contraction:
    y_full[n] = sum_m taps[m] x[n-m] evaluated as (frames @ W), the frames
    (B+K-1)-wide windows at stride B of the zero-padded signal and
    W[t, j] = taps[j+K-1-t] banded (one conv1d, exact f32).

    `origin` aligns the block grid to a global full-convolution index:
    output sample f lands in block column (f + origin) % B whatever the
    local offset, so a call on a piece of a longer signal sums each output
    as the call on the whole signal does.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import fir_convolve_1d
    >>> fir_convolve_1d(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([1.0, 1.0]))
    tensor([1., 3., 5., 7., 4.])
    """
    x = as_signal(x)
    taps = torch.as_tensor(taps, device=x.device).reshape(-1)
    k = taps.shape[0]
    length = x.shape[-1]
    full_len = length + k - 1
    block = _fir_block_size(k)
    shift = origin % block
    batch = x.shape[:-1]
    num_frames = -(-(full_len + shift) // block)
    total = num_frames * block + k - 1
    out_dtype = torch.promote_types(x.dtype, taps.dtype)
    xp = F.pad(x.to(out_dtype), (k - 1 + shift, total - (k - 1 + shift) - length))
    weights = _toeplitz_band_on(taps.to(out_dtype).detach(), block)
    y = blocked_frame_matmul(xp, weights,
                             window_length=block + k - 1, stride=block,
                             num_frames=num_frames)
    y = y.reshape(*batch, num_frames * block)[..., shift:shift + full_len]
    if mode == "full":
        return y
    if mode == "same":
        start = (k - 1) // 2
        return y[..., start:start + length]
    if mode == "valid":
        if length >= k:
            return y[..., k - 1:length]
        return y[..., length - 1:k]
    raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")


def _is_1d_fir_case(in1, in2) -> bool:
    """True when in2 convolves only the last axis (its leading axes are
    all 1): the Toeplitz contraction applies."""
    return (in1.ndim >= 1 and all(d == 1 for d in in2.shape[:-1])
            and in2.shape[-1] >= 2 and in1.shape[-1] >= 2)


def _parts(t):
    """(real, imag) of a tensor; a real tensor's imaginary part is zeros."""
    return (t.real, t.imag) if t.is_complex() else (t, torch.zeros_like(t))


def _direct_convolve(in1, in2, mode, use_matmul=True):
    in1, in2 = _operands(in1, in2)
    rank = _check_ranks(in1, in2)
    if rank == 0:
        return _float_cast(in1) * _float_cast(in2)
    if mode == "valid":
        in1, in2 = _valid_swap(in1, in2)
    in1 = _float_cast(in1)
    in2 = _float_cast(in2)
    if use_matmul and _is_1d_fir_case(in1, in2):
        return fir_convolve_1d(in1, in2, mode)

    # conv{1,2,3}d correlate: flip the kernel on every axis
    kernel = in2.flip(tuple(range(rank)))
    if mode == "same":
        # the extra sample of an even kernel goes on the LEFT, which centres
        # the output as scipy.signal.convolve(mode='same') does
        padding = [((k - 1) - (k - 1) // 2, (k - 1) // 2) for k in kernel.shape]
    elif mode == "full":
        padding = [(k - 1, k - 1) for k in kernel.shape]
    else:
        padding = [(0, 0)] * rank
    if not in1.is_complex() and not kernel.is_complex():
        return _conv_real(in1, kernel, padding)
    a, b = _parts(in1)
    c, d = _parts(kernel)
    real = _conv_real(a, c, padding) - _conv_real(b, d, padding)
    imag = _conv_real(a, d, padding) + _conv_real(b, c, padding)
    return torch.complex(real, imag)


def _centered(out, new_shape):
    """The centred slice of `out` with shape `new_shape`."""
    starts = [(cur - new) // 2 for cur, new in zip(out.shape, new_shape)]
    return out[tuple(slice(s, s + n) for s, n in zip(starts, new_shape))]


def _apply_mode(out, s1, s2, mode):
    if mode == "full":
        return out
    if mode == "same":
        return _centered(out, s1)
    if all(a >= b for a, b in zip(s1, s2)):
        big, small = s1, s2
    elif all(b >= a for a, b in zip(s1, s2)):
        big, small = s2, s1
    else:
        raise ValueError(
            "For 'valid' mode, one must be at least as large as the other in every dimension.")
    return _centered(out, [a - b + 1 for a, b in zip(big, small)])


def fftconvolve(in1, in2, *, mode="full"):
    """N-D FFT convolution: each axis where both operands have extent > 1
    is transformed at the next power of two >= N+K-1 (the others
    broadcast), the spectra multiplied and transformed back; the result is
    real iff both operands are.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import fftconvolve
    >>> fftconvolve(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 0.5])).round(decimals=4)
    tensor([-0.0000, 1.0000, 2.5000, 4.0000, 1.5000])
    """
    _check_mode(mode)
    in1, in2 = _operands(in1, in2)
    if in1.ndim != in2.ndim:
        raise ValueError("Rank of in1 and in2 must be equal.")
    if in1.ndim == 0:
        return _float_cast(in1) * _float_cast(in2)
    s1, s2 = tuple(in1.shape), tuple(in2.shape)
    axes = [ax for ax in range(in1.ndim) if s1[ax] != 1 and s2[ax] != 1]
    exact = [s1[ax] + s2[ax] - 1 for ax in axes]
    fast = [fft_fast_length(n) for n in exact]
    in1 = _float_cast(in1)
    in2 = _float_cast(in2)
    if not axes:
        out = in1 * in2
    elif in1.is_complex() or in2.is_complex():
        out = ifft_nd(fft_nd(in1, axes=axes, lengths=fast)
                      * fft_nd(in2, axes=axes, lengths=fast), axes=axes)
    else:
        sp = rfft_nd(in1, axes=axes, lengths=fast) * rfft_nd(in2, axes=axes, lengths=fast)
        out = irfft_nd(sp, axes=axes, lengths=fast)
    # trim the power-of-two padding back to the exact linear extent
    limits = list(out.shape)
    for ax, n in zip(axes, exact):
        limits[ax] = n
    out = out[tuple(slice(0, n) for n in limits)]
    full_shape = [a + b - 1 if ax in axes else max(a, b)
                  for ax, (a, b) in enumerate(zip(s1, s2))]
    if list(out.shape) != full_shape:
        out = out.expand(full_shape)
    return _apply_mode(out, s1, s2, mode)


def _oa_block_length(k: int) -> int:
    """The overlap-add FFT block: the power of two between 2K and 64K with
    the least FFT work per output sample."""
    best, best_cost = None, None
    n = fft_fast_length(2 * k)
    while n <= fft_fast_length(64 * k):
        cost = n * math.log2(max(n, 2)) / (n - k + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
        n = fft_fast_length(n + 1)
    return best


def oaconvolve(in1, in2, *, mode="full", block_length=None):
    """Overlap-add convolution along the last axis: the signal is cut into
    steps of B-K+1 samples, each block convolved with the kernel through an
    rfft of power-of-two length B, and the block tails overlap-added with
    the deterministic left fold `spectral.framing._ola_fold` (kernel C on a
    CUDA tensor). Leading axes broadcast. Mode semantics as `fftconvolve`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import oaconvolve
    >>> oaconvolve(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 1.0]), mode="same")
    tensor([1., 3., 5.])
    """
    _check_mode(mode)
    in1, in2 = _operands(in1, in2)
    if in1.ndim != in2.ndim:
        raise ValueError("Rank of in1 and in2 must be equal.")
    if in1.ndim == 0:
        return _float_cast(in1) * _float_cast(in2)
    s1, s2 = tuple(in1.shape), tuple(in2.shape)
    n, k = s1[-1], s2[-1]
    if n == 1 or k == 1 or any(a != 1 and b != 1 and a != b
                               for a, b in zip(s1[:-1], s2[:-1])):
        # degenerate or multi-axis cases
        return fftconvolve(in1, in2, mode=mode)
    signal, kernel = (in1, in2) if n >= k else (in2, in1)
    n, k = signal.shape[-1], kernel.shape[-1]
    signal = _float_cast(signal)
    kernel = _float_cast(kernel)

    block = int(block_length) if block_length is not None else _oa_block_length(k)
    block = max(block, k)
    step = block - k + 1
    num_blocks = -(-n // step)
    blocks = F.pad(signal, (0, num_blocks * step - n)).reshape(
        *signal.shape[:-1], num_blocks, step)
    if signal.is_complex() or kernel.is_complex():
        sp_k = torch.fft.fft(kernel, n=block, dim=-1)
        sp_b = torch.fft.fft(blocks, n=block, dim=-1)
        conv_blocks = torch.fft.ifft(sp_b * sp_k[..., None, :], dim=-1)
    else:
        sp_k = torch.fft.rfft(kernel, n=block, dim=-1)
        sp_b = torch.fft.rfft(blocks, n=block, dim=-1)
        conv_blocks = torch.fft.irfft(sp_b * sp_k[..., None, :], n=block, dim=-1)

    # each convolved block spans step + k - 1 samples; overlap k - 1
    full_len = n + k - 1
    out = _ola_fold(conv_blocks[..., :step + k - 1], step,
                    num_blocks * step + k - 1)[..., :full_len]
    full_shape = [max(a, b) for a, b in zip(s1[:-1], s2[:-1])] + [full_len]
    if list(out.shape) != full_shape:
        out = out.expand(full_shape)
    return _apply_mode(out, s1, s2, mode)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full"):
    """Lag indices of the output of `correlate(in1, in2, mode=mode)`, as
    scipy.signal.correlation_lags: lag k pairs in1 with in2 shifted by k
    samples. Host-side numpy.

    Examples:

    >>> from nx_signal_tpu_torch.ops.convolution import correlation_lags
    >>> correlation_lags(3, 3, mode="full")
    array([-2, -1,  0,  1,  2])
    """
    in1_len, in2_len = int(in1_len), int(in2_len)
    if in1_len < 1 or in2_len < 1:
        raise ValueError("input lengths must be >= 1")
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lag_bound = in1_len // 2
        if in1_len % 2 == 0:
            return lags[mid - lag_bound:mid + lag_bound]
        return lags[mid - lag_bound:mid + lag_bound + 1]
    if mode == "valid":
        if in1_len >= in2_len:
            return np.arange(in1_len - in2_len + 1)
        return np.arange(in1_len - in2_len, 1)
    raise ValueError(f"invalid mode, expected one of 'full', 'same', 'valid', got: {mode}")


def deconvolve(signal, divisor):
    """Polynomial deconvolution, scipy.signal.deconvolve's contract:
    (quotient, remainder) with signal = convolve(divisor, quotient) +
    remainder. The quotient is the impulse response of the filter
    b=signal, a=divisor over N - D + 1 samples (`ops.iir.lfilter`, as the
    JAX package computes it), in the operands' float dtype.

    Examples:

    (1 + x)^3 divided by (1 + x) gives (1 + x)^2 exactly:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import deconvolve
    >>> q, r = deconvolve(torch.tensor([1.0, 3.0, 3.0, 1.0]), torch.tensor([1.0, 1.0]))
    >>> q, r
    (tensor([1., 2., 1.]), tensor([0., 0., 0., 0.]))
    """
    num = torch.atleast_1d(as_signal(signal))
    den = torch.atleast_1d(torch.as_tensor(divisor, device=num.device))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("deconvolve requires 1-D signal and divisor")
    n = num.shape[0] - den.shape[0] + 1
    if n <= 0:
        return torch.zeros((0,), dtype=num.dtype, device=num.device), num
    impulse = torch.zeros((n,), dtype=num.dtype, device=num.device)
    impulse[0] = 1
    quot = lfilter(num, den, impulse)
    return quot, num - convolve(den, quot, mode="full")


def choose_conv_method(in1, in2, mode: str = "full"):
    """'direct' or 'fft' for `convolve`, by operand size: 'fft' only when
    the smaller operand has at least 4096 elements (the JAX package's
    crossover; the H100's is not measured), and 'direct' for two integer
    operands (exact, as scipy).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.convolution import choose_conv_method
    >>> choose_conv_method(torch.zeros(100), torch.zeros(5))
    'direct'
    """
    in1, in2 = _operands(in1, in2)

    def integer(dtype):
        return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)

    if integer(in1.dtype) and integer(in2.dtype):
        return "direct"
    if in1.ndim != in2.ndim:
        return "direct"  # fftconvolve requires equal ranks
    small = min(math.prod(max(1, int(s)) for s in in1.shape),
                math.prod(max(1, int(s)) for s in in2.shape))
    return "fft" if small >= 4096 else "direct"
