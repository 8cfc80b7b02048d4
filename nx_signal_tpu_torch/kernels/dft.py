"""Framing + window + DFT as a blocked frame contraction (counterpart of
nx_signal_tpu/kernels/dft.py): host weight functions and the plain paths.

The framed DFT is written as one contraction over the frame axis,

    z = frames(x) @ (diag(window) @ F)          F = DFT matrix [frame, bins]

and the FIR chain folds the banded 'same' Toeplitz matrix of the taps into
the same weights, z = frames_ext(x) @ (T @ diag(window) @ F). Real and
imaginary parts ride one stacked [Re | Im] weight matrix.

The weights are built on the host in f64 numpy (the same arithmetic as the
JAX package, so they are bitwise equal to its weights) and cast to f32.
The contraction runs as

* the hand-written CUDA kernels of `kernels/cuda_dft.py` on a CUDA tensor
  inside their contract (real input; the fused chain additionally needs
  output='power', onesided=True); the framed DFT runs there as a real FFT
  per frame (kernel B-fft) for every n_fft from 8 to 65536, and the
  one-sided framed inverse DFT as an inverse real FFT per frame (kernel
  B-ifft) for a power-of-two n_fft from 8 to 1024;
* otherwise `blocked_frame_matmul`, whose 'conv' strategy is one
  `torch.nn.functional.conv1d` over the non-overlapping (blocks, stride)
  view of the signal, in exact f32 (TF32 off on CUDA).

`fir_framed_dft_shared` computes the same chain through shared hop-block
partial DFTs (half the contraction FLOPs for cosine-sum windows with
frame_length == n_fft and stride | n_fft): a per-block contraction, a
twiddle combine across the J = n_fft/stride blocks of a frame, and the
window as a sparse spectral convolution. Its power output is kernel D
(`kernels/cuda_dft.py:fir_framed_dft_power_shared_cuda`) on a CUDA tensor.

`precision` ('highest' | 'high' | 'default') shapes the fused power chain
only: 'highest' is exact f32 (kernel A), 'high' 3xTF32 and 'default' one
TF32 pass (kernel A-tc, whose plain version `_framed_matmul_tf32_torch`
rounds the operands to TF32 by the tensor cores' rule, `_round_tf32`).
Every other path runs exact f32 at every precision.
"""

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.profiling import span
from nx_signal_tpu_torch.utils.shapes import _frame_block_widths

__all__ = ["framed_dft", "framed_idft", "fir_framed_dft", "fir_dft_fold_weights",
           "good_matmul_fft_length", "blocked_frame_matmul", "toeplitz_band",
           "fir_framed_dft_shared", "recognize_cosine_window", "shared_fold_weights",
           "shared_twiddles"]

_MAX_MATMUL_FFT = 1024
_PRECISIONS = ("highest", "high", "default")
_FEW_COLUMNS = 16  # blocked_frame_matmul: out_cols x C up to this is one matmul
# Share of the card's free memory that frame_chunks='auto' plans against:
# the plain power path's peak above its inputs read 1.16x the plan's model
# of it (13.78 of 11.85 GiB for the bench chain at 768 x 480000 on an
# NVIDIA H100 80GB HBM3, chip_smoke.py phase 7; the conv1d's output and its
# transposed copy are both of the intermediate's size), and cuDNN's
# workspace and the caching allocator's slack take more
_CHUNK_MEMORY_SHARE = 0.5


def _check_precision(precision):
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")


def _host_f64(a):
    """A tensor or array-like as a host f64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


@contextlib.contextmanager
def _exact_f32():
    """Run f32 matmuls and convolutions without TF32 on CUDA (cuDNN's
    convolution default is TF32, which keeps about three digits)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _memory_budget(device):
    """Bytes frame_chunks='auto' plans against on `device`: on a card its
    free memory (`torch.cuda.mem_get_info`) and what the caching allocator
    holds unused, times `_CHUNK_MEMORY_SHARE`; None on the CPU, where the
    plan is 1."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return _CHUNK_MEMORY_SHARE * (free + cached)


def _auto_frame_chunks(batch_elems: int, num_frames: int, cols: int, in_elems: int,
                       budget) -> int:
    """The JAX package's chunk plan (its `kernels/dft.py:_auto_frame_chunks`)
    against `budget` bytes (None: no plan, 1). Modelled footprints (f32
    bytes): unchunked = input + padded copy + power output + 1.15x the
    (batch, frames, cols) intermediate; chunked = the same with the
    intermediate divided by k and one more output-sized buffer. Returns 1
    wherever the unchunked path fits, else the fewest chunks that fit, at
    most num_frames.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import _auto_frame_chunks
    >>> _auto_frame_chunks(768, 3747, 514, 768 * 480000, 40e9)
    1
    >>> _auto_frame_chunks(768, 3747, 514, 768 * 480000, 10e9)
    6
    """
    if budget is None:
        return 1
    in_b = 4 * in_elems
    out_b = 4 * batch_elems * num_frames * (cols // 2 + 1)
    inter = 4 * batch_elems * num_frames * cols
    if 2 * in_b + out_b + 1.15 * inter <= budget:
        return 1
    # past the fixed buffers at least 5% of the budget: more chunks cannot
    # help beyond that, so chunk hard and let the attempt decide
    avail = max(budget - (2 * in_b + 2 * out_b), 0.05 * budget)
    return min(num_frames, max(1, int(-(-inter // avail))))


def toeplitz_band(taps, out_cols: int):
    """Banded Toeplitz matrix of 1-D convolution, built in numpy:
    T[t, j] = taps[j + K-1 - t] for j <= t <= j+K-1, else 0, shape
    (out_cols + K - 1, out_cols), so frames_ext @ T applies the filter.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.kernels.dft import toeplitz_band
    >>> toeplitz_band(np.array([1.0, 2.0, 3.0]), 2)
    array([[3., 0.],
           [2., 3.],
           [1., 2.],
           [0., 1.]])
    """
    taps = np.asarray(taps).reshape(-1)
    k = taps.shape[0]
    t_idx = np.arange(out_cols + k - 1)[:, None]
    j_idx = np.arange(out_cols)[None, :]
    m = j_idx + (k - 1) - t_idx
    return np.where((m >= 0) & (m < k), np.take(taps, np.clip(m, 0, k - 1)),
                    taps.dtype.type(0))


def good_matmul_fft_length(n_fft: int) -> bool:
    """True when the framed DFT runs as a contraction (n_fft <= 1024);
    larger transforms use torch.fft. The JAX package's cut, measured for its
    chip: the routes keep it for every signal but a CUDA float32 one, which
    follows the H100's own times (`kernels.cuda_dft._auto_takes_kernel`).

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import good_matmul_fft_length
    >>> good_matmul_fft_length(512), good_matmul_fft_length(4096)
    (True, False)
    """
    return n_fft <= _MAX_MATMUL_FFT


def blocked_frame_matmul(x, weights, *, window_length: int, stride: int,
                         num_frames: int, precision="highest",
                         strategy: str = "conv"):
    """Compute `as_windowed(x, window_length, stride)[..., :num_frames, :] @
    weights` without a gather. The signal is zero-padded on the right to
    the (num_frames + C - 1) whole hop blocks the frames touch, C =
    ceil(window_length / stride).

    * 'conv' (default): the (blocks, stride) view of the signal is the
      input of one conv1d with C taps, w[o, i, r] = weights[r*stride + i, o]
      (both conv1d and the frame product are cross-correlations: no flip).
      With few output columns (out_cols x C <= 16, e.g. the per-segment
      detrend coefficients of spectral/estimation.py) it is one matmul of
      the (blocks, stride) view against the weights' C row blocks, and
      each frame adds its C block products: a conv1d with one or two
      output channels runs far below the bytes it reads. The frame matrix
      is never built.
    * 'materialize': build the (num_frames, window_length) frames and run
      one matmul (complex signals and weights: `conv1d` takes real ones).
    * 'blocked': C partial matmuls, hop block r of every frame times rows
      r*stride onward of the weights, added in increasing r: no frame
      matrix and no banded kernel, the least peak memory.

    The signal and weights meet in their promoted dtype. Both strategies
    run exact f32 (TF32 off on CUDA, complex matmuls included) whatever
    `precision` says.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.dft import blocked_frame_matmul
    >>> x = torch.sin(0.1 * torch.arange(1024.0))
    >>> wts = torch.randn(256, 8, generator=torch.Generator().manual_seed(0))
    >>> blocked_frame_matmul(x, wts, window_length=256, stride=64, num_frames=13).shape
    torch.Size([13, 8])
    """
    _check_precision(precision)
    if strategy not in ("conv", "materialize", "blocked"):
        raise ValueError(
            f"strategy must be 'conv', 'materialize' or 'blocked', got {strategy!r}")
    x = as_signal(x)
    weights = torch.as_tensor(weights, device=x.device)
    dtype = torch.promote_types(x.dtype, weights.dtype)  # e.g. a complex signal, real weights
    x, weights = x.to(dtype), weights.to(dtype)
    widths = _frame_block_widths(window_length, stride)
    c_blocks = len(widths)
    needed = (num_frames + c_blocks - 1) * stride
    batch = x.shape[:-1]
    if needed > x.shape[-1]:
        x = F.pad(x, (0, needed - x.shape[-1]))
    x = x[..., :needed]
    out_cols = weights.shape[-1]
    with _exact_f32():
        if strategy == "conv":
            pad_rows = c_blocks * stride - window_length
            w = F.pad(weights, (0, 0, 0, pad_rows)) if pad_rows else weights
            if out_cols * c_blocks <= _FEW_COLUMNS:
                # (N, blocks, stride) @ (stride, C * O): block b's product with
                # row block c, then frame m = sum over c of block m + c's
                blocks = x.reshape(-1, num_frames + c_blocks - 1, stride)
                w_cols = w.reshape(c_blocks, stride, out_cols).permute(1, 0, 2)
                part = torch.matmul(blocks, w_cols.reshape(stride, c_blocks * out_cols))
                part = part.view(-1, num_frames + c_blocks - 1, c_blocks, out_cols)
                out = part[:, :num_frames, 0]
                for c in range(1, c_blocks):
                    out = out + part[:, c:c + num_frames, c]
                return out.reshape(*batch, num_frames, out_cols)
            kernel = w.reshape(c_blocks, stride, out_cols).permute(2, 1, 0)  # (O, I, C)
            blocks = x.reshape(-1, num_frames + c_blocks - 1, stride).transpose(1, 2)
            out = F.conv1d(blocks, kernel.contiguous())                 # (N, O, M)
            return out.transpose(1, 2).reshape(*batch, num_frames, out_cols)
        if strategy == "blocked":
            acc = None
            for r, w_r in enumerate(widths):
                block = x[..., r * stride:(r + num_frames) * stride]
                block = block.reshape(*batch, num_frames, stride)[..., :w_r]
                part = torch.matmul(block, weights[r * stride:r * stride + w_r])
                acc = part if acc is None else acc + part
            return acc
        frames = x.unfold(-1, window_length, stride)[..., :num_frames, :]
        return torch.matmul(frames, weights)


def _dft_weights(window, frame_length: int, n_fft: int, onesided: bool, dtype):
    """[Wr | Wi] stacked (frame_length, 2*bins) numpy array: the
    window-scaled DFT matrix restricted to the first frame_length input
    rows (zero-padding to n_fft is implicit), built in f64."""
    bins = n_fft // 2 + 1 if onesided else n_fft
    bins_idx = np.arange(bins)[None, :]
    n = np.arange(frame_length)[:, None]
    angle = -2.0 * np.pi * n * bins_idx / n_fft
    w = np.asarray(window, dtype=np.float64)[:, None]
    wr = w * np.cos(angle)
    wi = w * np.sin(angle)
    return np.concatenate([wr, wi], axis=1).astype(dtype)


def _frame_contract(x, weights, *, stride: int, pad_left: int, num_frames: int, dtype):
    """frames_ext(x) @ weights in `dtype`: extended frame m covers
    x[m*stride - pad_left : ... + weights rows], zeros outside the signal."""
    x = x.to(dtype)
    c_blocks = -(-weights.shape[0] // stride)
    needed = (num_frames + c_blocks - 1) * stride
    xp = F.pad(x, (pad_left, max(0, needed - pad_left - x.shape[-1])))
    return blocked_frame_matmul(xp, weights.to(dtype), window_length=weights.shape[0],
                                stride=stride, num_frames=num_frames)


def _framed_matmul_torch(x, weights, *, stride: int, pad_left: int, num_frames: int,
                         bins: int, power: bool, accumulate=DEFAULT_FLOAT):
    """Plain version of the framed-DFT kernels (`kernels/cuda_dft.py`):
    extended frame m covers x[m*stride - pad_left : ... + weights rows],
    with zeros outside the signal. Returns the stacked (..., M, 2*bins)
    [Re | Im] or, with `power`, re^2 + im^2 (..., M, bins). The f32
    signal and weights are contracted in `accumulate` (float64: exact
    products, f64 sums) and the result rounded to f32."""
    acc = _frame_contract(x.to(DEFAULT_FLOAT), weights.to(DEFAULT_FLOAT), stride=stride,
                          pad_left=pad_left, num_frames=num_frames,
                          dtype=accumulate).to(DEFAULT_FLOAT)
    if power:
        return acc[..., :bins] ** 2 + acc[..., bins:] ** 2
    return acc


def _round_tf32(t):
    """f32 values rounded to TF32 (10 explicit mantissa bits) as the tensor
    cores' `cvt.rna.tf32.f32` does: to nearest, ties away from zero, on the
    low 13 mantissa bits, which come out zero. Adding half an ulp to the
    magnitude bits and clearing them rounds both signs alike.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.dft import _round_tf32
    >>> ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])  # half an ulp of TF32
    >>> _round_tf32(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    True
    """
    bits = t.to(DEFAULT_FLOAT).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(DEFAULT_FLOAT)


def _tf32_split(t):
    """(hi, lo) TF32 parts of the f32 tensor: hi = tf32(t), lo = tf32(t - hi)."""
    hi = _round_tf32(t)
    return hi, _round_tf32(t.to(DEFAULT_FLOAT) - hi)


def _tf32_passes(precision) -> int:
    """TF32 products per term of the tensor-core contraction: 3 for 'high'
    (x_lo W_hi + x_hi W_lo + x_hi W_hi), 1 for 'default' (x_hi W_hi)."""
    if precision not in ("high", "default"):
        raise ValueError(f"the TF32 contraction takes precision 'high' or 'default', "
                         f"got {precision!r}")
    return 3 if precision == "high" else 1


def _framed_matmul_tf32_torch(x, weights, *, passes: int, stride: int, pad_left: int,
                              num_frames: int, bins: int):
    """Plain version of kernel A-tc (`kernels/cuda_dft.py`): the power
    |frames_ext(x) @ W|^2 with x and W rounded to TF32 by the kernel's rule
    (`_tf32_split`) and each term taken as x_lo W_hi + x_hi W_lo + x_hi W_hi
    (passes=3, 'high') or x_hi W_hi (passes=1, 'default'). The products are
    summed in f64 and rounded to f32 once; re^2 + im^2 is f32."""
    x_hi, x_lo = _tf32_split(x)
    w_hi, w_lo = _tf32_split(weights)
    kw = dict(stride=stride, pad_left=pad_left, num_frames=num_frames, dtype=torch.float64)
    if passes == 1:
        acc = _frame_contract(x_hi, w_hi, **kw)
    else:  # x_hi (W_hi + W_lo) is exact in f64: 11 x 22 significant bits
        acc = (_frame_contract(x_hi, w_hi.double() + w_lo.double(), **kw)
               + _frame_contract(x_lo, w_hi, **kw))
    acc = acc.to(DEFAULT_FLOAT)
    return acc[..., :bins] ** 2 + acc[..., bins:] ** 2


def framed_dft(x, window, *, stride: int, n_fft: int, onesided: bool = False,
               precision="highest", output: str = "complex"):
    """Windowed framed DFT of the (..., L) real signal: complex64
    (..., M, bins) with M = (L - frame_length)//stride + 1, equal (to f32
    accuracy) to `fft(as_windowed(x, frame, stride) * window, n_fft)`.
    `output='power'` returns re^2 + im^2 instead. The signal must already
    be padded (spectral/stft.py handles the padding modes).

    A frame longer than n_fft is folded modulo n_fft (the DFT's period), as
    the JAX package's frame_length-row weights fold it.

    Runs kernel B: `kernels.cuda_dft.framed_fft_cuda` (a real FFT per
    frame in shared memory: radix 8 for a power of two, mixed radix 2-13
    for a 13-smooth n_fft, Bluestein's chirp-z transform on power-of-two
    radix-8 passes for a larger prime factor; a long frame folded in its
    load; a transform too large for one CTA spread over a cluster of 2 to
    16 CTAs) for every n_fft from 8 to 65536 (`fft_kernel_takes`), and
    `kernels.cuda_dft.framed_dft_cuda` (the dense contraction, whose
    (frame, 2*bins) weights pass 17 GB at a frame of n_fft past 65536) for
    an n_fft below 8 or above 65536. Both are hand-written kernels on a
    CUDA tensor and the same plain conv1d version on a CPU one.

    Examples:

    >>> import numpy as np
    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.kernels.dft import framed_dft
    >>> x = torch.sin(0.1 * torch.arange(1024.0))
    >>> z = framed_dft(x, hann(256, device="cpu"), stride=64, n_fft=256, onesided=True)
    >>> z.shape
    torch.Size([13, 129])
    >>> frame0 = (x[:256] * hann(256, device="cpu")).numpy()
    >>> bool(np.abs(z[0].numpy() - np.fft.rfft(frame0)).max() < 1e-3)
    True
    """
    from nx_signal_tpu_torch.kernels.cuda_dft import (
        fft_kernel_takes, framed_dft_cuda, framed_fft_cuda)

    _check_precision(precision)
    x = as_signal(x)
    if x.is_complex():
        raise ValueError("framed_dft needs a real signal")
    if not isinstance(window, torch.Tensor):
        window = _host_f64(window)
    frame_length = window.shape[-1]
    num_frames = (x.shape[-1] - frame_length) // stride + 1
    if num_frames < 1:
        raise ValueError(
            f"window length {frame_length} exceeds signal length {x.shape[-1]}")
    if fft_kernel_takes(n_fft):
        return framed_fft_cuda(x, window, stride=stride, n_fft=n_fft, onesided=onesided,
                               output=output)
    weights = torch.as_tensor(
        _dft_weights(_host_f64(window), frame_length, n_fft, onesided, np.float32),
        device=x.device)
    return framed_dft_cuda(x, weights, stride=stride, num_frames=num_frames,
                           bins=n_fft // 2 + 1 if onesided else n_fft, output=output)


def _fft_twiddles(n_fft: int, *, device):
    """The (n_fft, 2) f32 table exp(-2 pi i t / n_fft), t = 0..n_fft-1, of
    the FFT kernel (cos, sin pairs computed in f64, then cast).

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import _fft_twiddles
    >>> _fft_twiddles(8, device="cpu")[2].tolist()
    [0.0, -1.0]
    """
    return torch.as_tensor(_unit_roots(np.arange(n_fft), n_fft).astype(np.float32), device=device)


def _unit_roots(num, den):
    """exp(-2 pi i num / den) in f64 as (..., 2) (cos, sin) pairs, num
    reduced mod den first, exact zeros at the quarter turns."""
    ang = -2.0 * np.pi * (np.asarray(num) % den) / den
    table = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    table[np.abs(table) < 1e-15] = 0.0
    return table


class FftPlan(NamedTuple):
    """Kernel B-fft's plan for an n_fft (`_fft_plan`, `_bluestein_plan`)."""

    length: int          # L, points of the transform: n_fft/2 (even), n_fft (odd)
    points: int          # M, points of the Stockham passes: L, or Bluestein's M >= 2L - 1
    radices: tuple       # the passes' radices, in order (product M)
    pads: tuple          # each pass's output padding c (see `_fft_plan`)
    table: np.ndarray    # (entries, 2) f64 twiddles, in the order the kernel reads them


# Radix 9 takes the 3s in pairs: every 13-smooth M up to 131072 (B-fft's
# largest) then needs at most 8 passes (93750 = 2 * 3 * 5^6 the most), where
# 3^9 = 19683 alone would need 9 of radix 3
_ODD_RADICES = (13, 11, 9, 7, 5, 3)


def _radices(points: int):
    """The Stockham radices of a 13-smooth length, in the plan's order:
    radix 8 and a 4 or 2 for the powers of two, then 13, 11, 9, 7, 5, 3
    (at most one 3); None for a length with a larger prime factor.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import _radices
    >>> _radices(19683), _radices(32768), _radices(1021)
    ([9, 9, 9, 9, 3], [8, 8, 8, 8, 8], None)
    """
    if points < 1:
        return None
    rest, odd = points, []
    for r in _ODD_RADICES:
        while rest % r == 0:
            odd.append(r)
            rest //= r
    twos = rest.bit_length() - 1
    if rest != 1 << twos:
        return None
    return [8] * (twos // 3) + ([1 << twos % 3] if twos % 3 else []) + odd


# Past this many points a pass keeps its output padding only where it adds
# at most 1/8 to the buffer, so that two M-point buffers stay within one
# CTA's shared memory (framed_fft.cu)
_FULL_PAD_POINTS = 2048


def _passes(points: int, radices):
    """Each pass's output padding c and the twiddle tables of the passes
    after the first (see `_fft_plan`)."""
    pads, tables, ns = [], [], 1
    for r in radices:
        group = ns * r
        if group == points:
            c = 0
        elif ns == 1:
            c = 1 - r % 2
        else:
            c = (ns - group) % 16
        pads.append(0 if points > _FULL_PAD_POINTS and 8 * c > group else c)
        if ns > 1:
            tables.append(_unit_roots(np.arange(r)[:, None] * np.arange(ns), group).reshape(-1, 2))
        ns = group
    return tuple(pads), tables


def _transform_length(n_fft: int) -> int:
    if n_fft < 2:
        raise ValueError(f"n_fft must be at least 2, got {n_fft}")
    return n_fft // 2 if n_fft % 2 == 0 else n_fft


def _post_twiddles(n_fft: int, length: int):
    """The split post-pass's twiddles exp(-2 pi i k / n_fft), k = 0..L/2
    (even n_fft; none for odd)."""
    return _unit_roots(np.arange(length // 2 + 1), n_fft) if n_fft % 2 == 0 else np.zeros((0, 2))


def _fft_plan(n_fft: int) -> FftPlan:
    """The pass plan and twiddle table of kernel B-fft (framed_fft.cu) for
    a 13-smooth n_fft (prime factors 2, 3, 5, 7, 11, 13 only).

    A real frame of even n_fft is one complex FFT of L = n_fft/2 points
    (even samples real, odd imaginary) and a split post-pass; two real
    frames of odd n_fft are one complex FFT of L = n_fft points (frame m
    real, frame m+1 imaginary) and a separation. The FFT runs Stockham
    autosort passes of radix 8 and a 4 or 2 for the powers of two, then 13,
    11, 9, 7, 5, 3 (largest first), an order that keeps the padded buffers
    small. Pass p, after Ns points have been combined, takes butterfly j
    (0 <= j < L/R) from points j + r L/R, r < R, scales point r by
    exp(-2 pi i (j mod Ns) r / (Ns R)), and writes its DFT to
    (j // Ns) Ns R + j mod Ns + r Ns; its output index i is stored at
    i + (i // (Ns R)) c against shared-memory bank conflicts, with c = 0
    for an odd radix and 1 for an even one in the first pass (Ns = 1: an odd
    store stride), c = (Ns - Ns R) mod 16 in later passes (the 16 lanes of
    a half-warp store to distinct banks), and c = 0 in the last pass; past
    2048 points (`_FULL_PAD_POINTS`) c is 0 wherever c > Ns R / 8, so that
    no buffer grows by more than 1/8.

    `table` holds, in order: for even n_fft the post-pass twiddles
    exp(-2 pi i k / n_fft), k = 0..L/2; then for each pass after the first
    its Ns R entries exp(-2 pi i jm r / (Ns R)) at r Ns + jm.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import _fft_plan
    >>> plan = _fft_plan(600)
    >>> plan.length, plan.radices, plan.pads, plan.table.shape
    (300, (4, 5, 5, 3), (1, 0, 0, 0), (571, 2))
    >>> _fft_plan(572).radices
    (2, 13, 11)
    >>> _fft_plan(65536).radices, _fft_plan(19683).radices
    ((8, 8, 8, 8, 8), (9, 9, 9, 9, 3))
    """
    length = _transform_length(n_fft)
    radices = _radices(length)
    if radices is None:
        raise ValueError(f"n_fft must be 13-smooth (factors 2, 3, 5, 7, 11, 13), got {n_fft}")
    pads, tables = _passes(length, radices)
    return FftPlan(length, length, tuple(radices), pads,
                   np.concatenate([_post_twiddles(n_fft, length), *tables]))


def _smooth_points(length: int) -> int:
    """The smallest 13-smooth M >= 2L - 1 (the mixed-radix kernel's
    Bluestein length)."""
    points = 2 * length - 1
    while _radices(points) is None:
        points += 1
    return points


# Bluestein's M: the power of two P >= 2L - 1 (radix-8 passes, on B-fft's
# persistent loop kernel to 8192 points, 4096 for odd n_fft) unless P is
# more than this many times the smallest 13-smooth S >= 2L - 1 (the
# mixed-radix kernel, whose passes cost more a point). From
# scripts/torch_kernel_variants.py section 6 on an NVIDIA H100 80GB HBM3 at
# 700 W (64 x 480000, hann frame n_fft, hop n_fft / 4; ms, P against S, at
# P / S): P won at every ratio up to 1.302 (997 1.41 / 3.30 at 1.02, 4093
# 3.16 / 3.54 and 4094 1.38 / 2.59 at 1.00, 802 1.64 / 3.29 at 1.26, 787
# 1.69 / 1.87 at 1.30); S won at 11 of the 13 lengths from 1.330 (3079
# 3.82 / 2.09 and 6151 7.28 / 3.07 at 1.33, 1367 2.19 / 1.84, 2731 4.28 /
# 2.08 at 1.49, 662 1.96 / 1.71 at 1.52, 541, 526, 514, 1031, 2053 and 8209
# by 1.27-2.5x at 1.88-1.99), lost at 683 (1.97 / 2.19 at 1.50) and tied at
# 603 (2.20 / 2.22 at 1.69)
_SMOOTH_M_RATIO = 1.31


def _bluestein_points(length: int) -> int:
    """Bluestein's M for a transform of L points: the power of two P >= 2L
    - 1 (up to 131072 for L up to 65535; B-fft runs it on its persistent
    radix-8 kernel to 8192, 4096 for odd n_fft, and on the mixed-radix
    kernel past that, over a cluster of CTAs past about 14000 points), or
    the smallest 13-smooth S >= 2L - 1 (`_smooth_points`, the mixed-radix
    kernel) where P > `_SMOOTH_M_RATIO` S.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import _bluestein_points
    >>> _bluestein_points(1021), _bluestein_points(4093), _bluestein_points(8191)
    (2048, 8192, 16384)
    >>> _bluestein_points(1031)   # P = 4096 is 1.97 S
    2079
    >>> _bluestein_points(32749), _bluestein_points(65535)   # odd n_fft past 32767
    (65536, 131072)
    """
    power = 1 << (2 * length - 2).bit_length()
    smooth = _smooth_points(length)
    return smooth if power > _SMOOTH_M_RATIO * smooth else power


def _bluestein_plan(n_fft: int, points=None) -> FftPlan:
    """Kernel B-fft's plan for any n_fft as a chirp-z (Bluestein) transform:
    the complex DFT of L points (L as in `_fft_plan`) becomes, with the
    chirp w_j = exp(-pi i j^2 / L),

        Z[k] = w_k sum_j (z_j w_j) conj(w_{k-j}),

    a circular convolution of M points, M = `points` or, where None,
    `_bluestein_points(L)` (a power of two >= 2L - 1, or the smallest
    13-smooth one where the power of two nearly doubles it): z_j w_j
    zero-padded to M, a forward FFT of M points on the plan's passes, a
    product with the FFT of the conjugate chirp (j and M - j for 0 <= j <
    L, zeros between), divided by M, an inverse FFT of M points as conj,
    forward FFT, conj, and a last product with w_k. Then the split
    post-pass or the separation of `_fft_plan`.

    `table` holds, in order: the post-pass twiddles (even n_fft), the
    chirp w_j (L entries), the filter's spectrum (M entries), then the
    passes' twiddles of the M-point plan. All are formed in f64: j^2 is
    reduced mod 2L in integers before any angle is formed.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import _bluestein_plan
    >>> plan = _bluestein_plan(1021)
    >>> plan.length, plan.points, plan.radices
    (1021, 2048, (8, 8, 8, 4))
    >>> _bluestein_plan(1018).points, _bluestein_plan(997).points
    (1024, 2048)
    >>> _bluestein_plan(997, points=2000).radices   # the 13-smooth M
    (8, 2, 5, 5, 5)
    """
    length = _transform_length(n_fft)
    points = _bluestein_points(length) if points is None else points
    radices = _radices(points)
    if radices is None or points < 2 * length - 1:
        raise ValueError(f"Bluestein's M must be 13-smooth and >= 2L - 1 = {2 * length - 1}, "
                         f"got {points}")
    pads, tables = _passes(points, radices)
    j = np.arange(length)
    chirp = _unit_roots(j * j % (2 * length), 2 * length)
    filt = np.zeros(points, complex)
    filt[j] = chirp[:, 0] - 1j * chirp[:, 1]
    filt[points - j[1:]] = filt[j[1:]]
    spectrum = np.fft.fft(filt) / points
    return FftPlan(length, points, tuple(radices), pads,
                   np.concatenate([_post_twiddles(n_fft, length), chirp,
                                   np.stack([spectrum.real, spectrum.imag], axis=-1), *tables]))


def _idft_weights(window, frame_length: int, n_fft: int, onesided: bool, dtype):
    """Inverse-DFT weights fused with the synthesis window, numpy f64 cast
    to `dtype`. Full spectrum: the real 2x2 block form [[Gr, Gi], [-Gi, Gr]]
    of G = (1/N) conj(F)[:, :frame_length] * w, mapping [Re z | Im z] to
    [Re frames | Im frames]. Onesided: (2*bins, frame_length) irfft weights
    with the conjugate-symmetry factor 2 on interior bins."""
    n = np.arange(frame_length)[None, :]
    w = np.asarray(window, dtype=np.float64)[None, :]
    if onesided:
        bins = n_fft // 2 + 1
        k = np.arange(bins)[:, None]
        factor = np.full((bins, 1), 2.0)
        factor[0, 0] = 1.0
        if n_fft % 2 == 0:
            factor[-1, 0] = 1.0
        angle = 2.0 * np.pi * k * n / n_fft
        g_re = factor * np.cos(angle) / n_fft * w
        g_im = -factor * np.sin(angle) / n_fft * w
        return np.concatenate([g_re, g_im], axis=0).astype(dtype)
    k = np.arange(n_fft)[:, None]
    angle = 2.0 * np.pi * k * n / n_fft
    g_re = np.cos(angle) / n_fft * w
    g_im = np.sin(angle) / n_fft * w
    top = np.concatenate([g_re, g_im], axis=1)      # z_re @ [Gr | Gi]
    bot = np.concatenate([-g_im, g_re], axis=1)     # z_im @ [-Gi | Gr]
    return np.concatenate([top, bot], axis=0).astype(dtype)


def _framed_idft_torch(z, window, *, n_fft: int, onesided: bool):
    """`framed_idft` as one exact-f32 product of [Re z | Im z] with the
    dense weights of `_idft_weights`, built in numpy f64 on every call: its
    route on the CPU and, on the card, wherever kernel B-ifft does not take
    the call (`kernels.cuda_dft.ifft_kernel_takes`)."""
    # the window's copy to the host, the numpy weights and their copy back
    # in one span, before the product's, so that a trace splits the two
    with span("nx.weights.idft"):
        window = _host_f64(window)
        frame_length = window.shape[-1]
        weights = torch.as_tensor(
            _idft_weights(window, frame_length, n_fft, onesided, np.float32), device=z.device)
    # mirror (i)fft length semantics: pad/truncate the bin axis
    bins = n_fft // 2 + 1 if onesided else n_fft
    with span("nx.idft.product"):
        re, im = z.real.to(DEFAULT_FLOAT), z.imag.to(DEFAULT_FLOAT)
        if z.shape[-1] != bins:
            re = F.pad(re, (0, bins - z.shape[-1]))
            im = F.pad(im, (0, bins - z.shape[-1]))
        with _exact_f32():
            out = torch.matmul(torch.cat([re, im], dim=-1), weights)
    if onesided:
        return out
    return torch.complex(out[..., :frame_length], out[..., frame_length:])


def framed_idft(z, window, *, n_fft: int, onesided: bool = False,
                precision="highest"):
    """Inverse of `framed_dft` fused with the synthesis-window multiply:
    (..., M, bins) spectrum -> windowed time frames (..., M, frame_length).
    Full-spectrum input returns complex frames (= ifft(z) * window);
    onesided input returns real frames (irfft). The bin axis is zero-padded
    or cut to n_fft//2 + 1 (onesided) or n_fft, as (i)fft's `n` does. The
    caller overlap-adds.

    On a CUDA complex64 spectrum that kernel B-ifft takes
    (`kernels.cuda_dft.ifft_kernel_takes`: onesided, n_fft a power of two
    from 8 to 1024, the window no longer than n_fft) it runs the kernel (an
    inverse real FFT a frame, `kernels.cuda_dft.framed_ifft_cuda`), with no
    host work and no sync; every other call, and every CPU one, is one
    exact-f32 product against dense weights built in numpy
    (`_framed_idft_torch`). Both run f32 at every `precision`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.kernels.dft import framed_dft, framed_idft
    >>> x = torch.sin(0.1 * torch.arange(1024.0))
    >>> z = framed_dft(x, hann(256, device="cpu"), stride=64, n_fft=256, onesided=True)
    >>> f = framed_idft(z, hann(256, device="cpu"), n_fft=256, onesided=True)
    >>> f.shape, f.dtype
    (torch.Size([13, 256]), torch.float32)
    """
    from nx_signal_tpu_torch.kernels.cuda_dft import framed_ifft_cuda, ifft_kernel_takes

    _check_precision(precision)
    z = as_signal(z)
    if not z.is_complex():
        z = z.to(torch.complex64)
    shape = np.shape(window)
    if (z.device.type == "cuda" and z.dtype == torch.complex64 and len(shape) == 1
            and ifft_kernel_takes(n_fft, shape[0], onesided)):
        # the launch where the product was, so that a trace reads it alike
        with span("nx.idft.product"):
            return framed_ifft_cuda(z, window, n_fft=n_fft)
    return _framed_idft_torch(z, window, n_fft=n_fft, onesided=onesided)


def fir_dft_fold_weights(taps, window, n_fft: int, onesided: bool, *, device=None):
    """The fused chain's weight matrix T @ diag(w) @ F, folded on the host
    in f64 and cast to f32: the banded 'same' Toeplitz of `taps` times the
    window-scaled DFT matrix. Shape (frame_length + K - 1, 2*bins), stacked
    [Re | Im], on `device` (None: the card); bitwise equal to the JAX
    package's fold.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.kernels.dft import fir_dft_fold_weights
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> fir_dft_fold_weights(np.array([0.25, 0.5, 0.25]), hann(256, device="cpu"), 256, True,
    ...                      device="cpu").shape
    torch.Size([258, 258])
    """
    taps = _host_f64(taps).reshape(-1)
    window = _host_f64(window)
    frame_length = window.shape[-1]
    toeplitz = toeplitz_band(taps, frame_length)
    dft_w = _dft_weights(window, frame_length, n_fft, onesided, np.float64)
    return torch.as_tensor((toeplitz @ dft_w).astype(np.float32), device=target_device(device))


def _same_pad_left(num_taps: int) -> int:
    """'same' alignment of the fused chain: frame m of the filtered signal
    starts at y[m*stride] = full_conv[m*stride + (K-1)//2], so the extended
    frame starts at x[m*stride - pad_left], pad_left = (K-1) - (K-1)//2."""
    return (num_taps - 1) - (num_taps - 1) // 2


def _fir_framed_dft_power_nopad(x, weights, *, stride: int, pad_left: int,
                                num_frames: int, bins: int):
    """The power chain with both 'same' edges as whole zero hop blocks of
    the conv's input instead of a padded copy of the signal: the folded
    weight rows shift down by s = (-pad_left) % stride so the left context
    starts on a block boundary. Needs the signal length to be a multiple of
    the hop and the shifted weights to keep their block count; returns None
    where the geometry does not apply (the caller takes the padded path).
    The extra all-zero weight rows add exact +0.0 terms."""
    ext, cols = weights.shape
    length = x.shape[-1]
    s = (-pad_left) % stride
    c_blocks = -(-ext // stride)
    if length % stride or s + ext > c_blocks * stride or c_blocks <= 1:
        return None
    batch = x.shape[:-1]
    w = F.pad(weights, (0, 0, s, c_blocks * stride - ext - s))
    kernel = w.reshape(c_blocks, stride, cols).permute(2, 1, 0).contiguous()  # (O, I, C)
    left_blocks = (pad_left + s) // stride
    n_in_blocks = length // stride
    # output position m contracts padded blocks [m, m + c_blocks); block j
    # of the padded sequence is input block j - left_blocks
    right_blocks = max(0, num_frames + c_blocks - 1 - (left_blocks + n_in_blocks))
    blocks = x.to(DEFAULT_FLOAT).reshape(-1, n_in_blocks, stride).transpose(1, 2)
    with _exact_f32():
        acc = F.conv1d(F.pad(blocks, (left_blocks, right_blocks)), kernel)
    acc = acc[..., :num_frames].transpose(1, 2).reshape(*batch, num_frames, cols)
    return acc[..., :bins] ** 2 + acc[..., bins:] ** 2


def fir_framed_dft(x, taps, window, *, stride: int, n_fft: int,
                   onesided: bool = False, precision="highest",
                   output: str = "complex", frame_chunks=1, edge: str = "pad",
                   kernel: str = "auto"):
    """FIR filtering fused into the framed DFT: the spectrum of
    convolve(x, taps, 'same') computed as one frame contraction against
    the folded weights T @ diag(w) @ F (`fir_dft_fold_weights`); the
    filtered signal is never built.

    `kernel`:
    * 'auto' runs `kernels.cuda_dft.fir_framed_dft_power_cuda` when the
      call is inside its contract (output='power', onesided=True, real
      input): kernel A at precision 'highest', kernel A-tc (3xTF32 for
      'high', one TF32 pass for 'default') otherwise, the hand-written
      kernel on a CUDA tensor and its plain version on a CPU one. Outside
      the contract, and with 'torch', the plain exact-f32 conv1d path runs
      whatever the precision. 'cuda' raises outside the contract.
    * 'cuda_shared' runs `fir_framed_dft_shared` (kernel D on a CUDA
      tensor, its plain version on a CPU one), the half-FLOP shared
      hop-block form. It raises unless output='power', onesided=True, the
      input is real, edge='pad', frame_length == n_fft, stride | n_fft,
      n_fft is even and the window is a recognized cosine-sum window
      (`recognize_cosine_window`). Any hop is taken.

    `frame_chunks` only shapes the plain power path (`kernel='torch'`): an
    integer k > 1 splits the frame axis into k sequential chunks so the
    (..., frames, 2*bins) intermediate exists one chunk at a time; 'auto'
    plans k from the card's free memory (`_auto_frame_chunks` against
    `_memory_budget`: 1 wherever the unchunked path fits, and always 1 on a
    CPU tensor). The kernels keep no intermediate, so they ignore the
    setting.

    `edge='conv'` (power output, unchunked, `kernel='torch'`) contracts
    the signal without a padded copy (`_fir_framed_dft_power_nopad`) where
    the hop divides the signal length, and falls back to `edge='pad'`
    elsewhere. Kernel A never copies the signal, so under 'auto' and
    'cuda' both edges run A.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.kernels.dft import fir_framed_dft
    >>> x = torch.sin(0.1 * torch.arange(1024.0))
    >>> p = fir_framed_dft(x, [0.25, 0.5, 0.25], hann(256, device="cpu"), stride=64, n_fft=256,
    ...                    onesided=True, output='power')
    >>> p.shape
    torch.Size([13, 129])
    """
    _check_precision(precision)
    if kernel not in ("auto", "torch", "cuda", "cuda_shared"):
        raise ValueError("kernel must be 'auto', 'torch', 'cuda' or 'cuda_shared', "
                         f"got {kernel!r}")
    if output not in ("complex", "power"):
        raise ValueError(f"output must be 'complex' or 'power', got {output!r}")
    if edge not in ("pad", "conv"):
        raise ValueError(f"edge must be 'pad' or 'conv', got {edge!r}")
    x = as_signal(x)
    taps = _host_f64(taps).reshape(-1)
    window = _host_f64(window)
    k = taps.shape[0]
    frame_length = window.shape[-1]
    length = x.shape[-1]
    if length < frame_length:
        raise ValueError(f"window length {frame_length} exceeds signal length {length}")
    num_frames = (length - frame_length) // stride + 1
    bins = n_fft // 2 + 1 if onesided else n_fft
    if frame_chunks != "auto" and (not isinstance(frame_chunks, (int, np.integer))
                                   or frame_chunks < 1):
        raise ValueError(
            f"frame_chunks must be 'auto' or an integer >= 1, got {frame_chunks!r}")
    eligible = output == "power" and onesided and not x.is_complex()
    if kernel == "cuda" and not eligible:
        raise ValueError(
            "kernel='cuda' requires output='power', onesided=True and real input")
    if kernel == "cuda_shared":
        if not (eligible and edge == "pad"):
            raise ValueError("kernel='cuda_shared' requires output='power', "
                             "onesided=True, real input and edge='pad'")
        coeffs = (recognize_cosine_window(window, n_fft)
                  if frame_length == n_fft and n_fft % stride == 0 and n_fft % 2 == 0
                  else None)
        if coeffs is None:
            raise ValueError(
                "kernel='cuda_shared' additionally requires frame_length == n_fft, "
                "stride | n_fft, even n_fft and a recognized cosine-sum window "
                "(see recognize_cosine_window)")
        return fir_framed_dft_shared(x, taps, stride=stride, n_fft=n_fft,
                                     window_coeffs=coeffs, onesided=True,
                                     precision=precision, output="power")
    weights = fir_dft_fold_weights(taps, window, n_fft, onesided, device=x.device)
    pad_left = _same_pad_left(k)
    if eligible and kernel != "torch":
        from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_cuda

        return fir_framed_dft_power_cuda(x, weights, stride=stride, pad_left=pad_left,
                                         num_frames=num_frames, bins=bins,
                                         precision=precision)

    power = output == "power"
    if edge == "conv" and power and frame_chunks in (1, "auto"):
        out = _fir_framed_dft_power_nopad(x, weights, stride=stride, pad_left=pad_left,
                                          num_frames=num_frames, bins=bins)
        if out is not None:
            return out
    if frame_chunks == "auto":
        frame_chunks = _auto_frame_chunks(
            int(np.prod(x.shape[:-1], dtype=np.int64)), num_frames, 2 * bins, x.numel(),
            _memory_budget(x.device)) if power else 1
    if not power or frame_chunks == 1:
        acc = _framed_matmul_torch(x, weights, stride=stride, pad_left=pad_left,
                                   num_frames=num_frames, bins=bins, power=power)
        return acc if power else torch.complex(acc[..., :bins], acc[..., bins:])
    # chunked: pad once, then contract each frame range of the padded signal
    c_blocks = -(-weights.shape[0] // stride)
    needed = (num_frames + c_blocks - 1) * stride
    xp = F.pad(x.to(DEFAULT_FLOAT), (pad_left, max(0, needed - pad_left - length)))
    out = torch.empty((*x.shape[:-1], num_frames, bins), dtype=DEFAULT_FLOAT,
                      device=x.device)
    per = -(-num_frames // frame_chunks)
    for f0 in range(0, num_frames, per):
        f1 = min(num_frames, f0 + per)
        out[..., f0:f1, :] = _framed_matmul_torch(
            xp[..., f0 * stride:(f1 + c_blocks - 1) * stride], weights, stride=stride,
            pad_left=0, num_frames=f1 - f0, bins=bins, power=True)
    return out


# --------------------------------------------------- shared-block strategy

#: signed cosine-sum coefficients of the standard periodic windows:
#: w[t] = sum_c b_c * cos(2*pi*c*t / N)
_COSINE_WINDOW_COEFFS = {
    "rectangular": (1.0,),
    "hann": (0.5, -0.5),
    "hamming": (0.54, -0.46),
    "blackman": (0.42, -0.5, 0.08),
}


def recognize_cosine_window(window, n_fft: int):
    """Signed cosine-sum coefficients (b_0, b_1, ...) of the PERIODIC
    window sampled in `window` when it matches one of the standard
    cosine-sum families over period `n_fft` to 1e-6, else None. Gate of
    the shared-block path (`fir_framed_dft_shared`), which applies the
    window as a sparse convolution in the frequency domain and so needs
    the window's exact spectral support.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import recognize_cosine_window
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> recognize_cosine_window(hann(256, device="cpu"), 256)
    (0.5, -0.5)
    >>> recognize_cosine_window(hann(256, periodic=False, device="cpu"), 256) is None
    True
    """
    w = _host_f64(window)
    if w.ndim != 1 or w.shape[0] != n_fft:
        return None
    t = np.arange(n_fft)
    for coeffs in _COSINE_WINDOW_COEFFS.values():
        model = sum(b * np.cos(2.0 * np.pi * c * t / n_fft) for c, b in enumerate(coeffs))
        if np.allclose(w, model, atol=1e-6):
            return tuple(coeffs)
    return None


def shared_fold_weights(taps, stride: int, n_fft: int, onesided: bool = True, *,
                        device=None):
    """The per-hop-block partial-DFT weights of the shared-block chain with
    the FIR folded in: toeplitz_band(taps, stride) @ E, E the (stride,
    2*bins) [Re | Im] DFT rows of one hop block (no window), folded on the
    host in f64 and cast to f32; shape (stride + K - 1, 2*bins), on `device`
    (None: the card). `taps=None` gives E itself. Bitwise equal to the JAX package's weights.

    Examples:

    >>> import numpy as np
    >>> from nx_signal_tpu_torch.kernels.dft import shared_fold_weights
    >>> shared_fold_weights(np.array([0.25, 0.5, 0.25]), 128, 512, device="cpu").shape
    torch.Size([130, 514])
    """
    e_mat = _dft_weights(np.ones(stride), stride, n_fft, onesided, np.float64)
    if taps is not None:
        e_mat = toeplitz_band(_host_f64(taps).reshape(-1), stride) @ e_mat
    return torch.as_tensor(e_mat.astype(np.float32), device=target_device(device))


def shared_twiddles(stride: int, n_fft: int, onesided: bool = True, *, device=None):
    """The (2, J, bins) f32 twiddles of the shared-block combine, cos then
    sin of -2 pi ((j * k * stride) % n_fft) / n_fft for the J = n_fft /
    stride blocks of a frame: the phase is reduced in integers before the
    f64 cos/sin, so no angle grows with j * k. On `device` (None: the
    card).

    Examples:

    >>> from nx_signal_tpu_torch.kernels.dft import shared_twiddles
    >>> shared_twiddles(128, 512, device="cpu").shape
    torch.Size([2, 4, 257])
    """
    bins = n_fft // 2 + 1 if onesided else n_fft
    jk = (np.arange(n_fft // stride)[:, None] * np.arange(bins)[None, :] * stride) % n_fft
    ang = -2.0 * np.pi * jk / n_fft
    return torch.as_tensor(np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32),
                           device=target_device(device))


def _conj_shift_minus(xr, xi, c: int, bins: int):
    """X[k - c] of a one-sided spectrum of a real signal: k < c reflects
    through DC with a conjugate (X[-q] = conj X[q])."""
    left_r = xr[..., 1:c + 1].flip(-1)
    left_i = -xi[..., 1:c + 1].flip(-1)
    return (torch.cat([left_r, xr[..., :bins - c]], dim=-1),
            torch.cat([left_i, xi[..., :bins - c]], dim=-1))


def _conj_shift_plus(xr, xi, c: int, bins: int):
    """X[k + c] of a one-sided spectrum of a real signal (even n_fft): past
    Nyquist reflects with a conjugate (X[n_fft - q] = conj X[q])."""
    right_r = xr[..., bins - 1 - c:bins - 1].flip(-1)
    right_i = -xi[..., bins - 1 - c:bins - 1].flip(-1)
    return (torch.cat([xr[..., c:], right_r], dim=-1),
            torch.cat([xi[..., c:], right_i], dim=-1))


def _shared_epilogue_torch(p, twiddles, window_coeffs, *, num_frames: int, bins: int,
                           onesided: bool):
    """Stages B and C of the shared-block chain on the stacked (..., blocks,
    2*bins) partial DFTs P: the twiddle combine X[m] = sum_j tw[j] P[m + j]
    and the cosine-sum window as its sparse spectral convolution. Returns
    (Re, Im) of the windowed (..., num_frames, bins) spectrum."""
    p_re, p_im = p[..., :bins], p[..., bins:]
    twr, twi = twiddles[0], twiddles[1]
    x_re = torch.zeros((*p.shape[:-2], num_frames, bins), dtype=DEFAULT_FLOAT,
                       device=p.device)
    x_im = torch.zeros_like(x_re)
    for j in range(twr.shape[0]):
        pr = p_re[..., j:j + num_frames, :]
        pi = p_im[..., j:j + num_frames, :]
        x_re = x_re + twr[j] * pr - twi[j] * pi
        x_im = x_im + twr[j] * pi + twi[j] * pr
    out_r = window_coeffs[0] * x_re
    out_i = window_coeffs[0] * x_im
    for c, b in enumerate(window_coeffs[1:], start=1):
        if b == 0.0:
            continue
        if onesided:
            mr, mi = _conj_shift_minus(x_re, x_im, c, bins)
            pr_, pi_ = _conj_shift_plus(x_re, x_im, c, bins)
        else:
            mr, mi = x_re.roll(c, -1), x_im.roll(c, -1)
            pr_, pi_ = x_re.roll(-c, -1), x_im.roll(-c, -1)
        out_r = out_r + (b / 2.0) * (mr + pr_)
        out_i = out_i + (b / 2.0) * (mi + pi_)
    return out_r, out_i


def _shared_partial_dfts(x, weights, *, stride: int, pad_left: int, num_blocks: int,
                         bins: int):
    """Stage A of the shared-block chain: the stacked (..., num_blocks,
    2*bins) partial DFTs P of the hop blocks, one conv1d contraction of the
    f32 signal and weights with f64 sums, rounded to f32 once.

    Stage C subtracts nearly equal neighbours: at the stopband bins of a
    low-pass chain the window's spectral convolution cancels the hop
    block's leakage, about 660x at the 255-tap / hann-512 / hop-128
    bench chain. P's rounding error grows by that factor there; an f32 sum
    (cuDNN's) left ~1e-4 of such a bin's maximum in the power, a correctly
    rounded P ~1e-5."""
    return _framed_matmul_torch(x, weights, stride=stride, pad_left=pad_left,
                                num_frames=num_blocks, bins=bins, power=False,
                                accumulate=torch.float64)


def _shared_power_torch(x, weights, twiddles, window_coeffs, *, stride: int,
                        pad_left: int, num_frames: int, bins: int):
    """Plain version of kernel D (`kernels/cuda_dft.py`): the one-sided
    power of the shared-block chain. Stage A is `_shared_partial_dfts`;
    stages B and C are elementwise f32 torch ops in the reference's
    order."""
    p = _shared_partial_dfts(x, weights, stride=stride, pad_left=pad_left,
                             num_blocks=num_frames + twiddles.shape[1] - 1, bins=bins)
    out_r, out_i = _shared_epilogue_torch(p, twiddles, window_coeffs,
                                          num_frames=num_frames, bins=bins, onesided=True)
    return out_r ** 2 + out_i ** 2


def fir_framed_dft_shared(x, taps, *, stride: int, n_fft: int, window_coeffs,
                          onesided: bool = False, precision="highest",
                          output: str = "complex"):
    """FIR + windowed framed DFT through SHARED hop-block partial DFTs: the
    half-FLOP form of `fir_framed_dft` for cosine-sum windows with
    frame_length == n_fft and stride | n_fft. Each hop block's partial DFT
    P[b] = x_block[b] @ E (the FIR folded into E, `shared_fold_weights`) is
    computed once and reused by the J = n_fft/stride frames that overlap it:

        X[m, k]  = sum_j tw[j, k] * P[m + j, k]                  (combine)
        Xw[m, k] = b_0 X[m, k] + sum_c (b_c / 2) (X[m, k-c] + X[m, k+c])

    the second line being the window w[t] = sum_c b_c cos(2 pi c t / n_fft)
    as its exact sparse spectral convolution (one-sided spectra reflect
    through DC and Nyquist with a conjugate). Per input sample the
    contraction costs 2*(stride + K - 1)*(2*bins)/stride FLOP instead of
    2*(n_fft + K - 1)*(2*bins)/stride. Equal to `fir_framed_dft` up to f32
    association (not bitwise: another summation order).

    `taps=None` skips the FIR. Needs n_fft % stride == 0, even n_fft for
    onesided=True, and the window as signed cosine coefficients
    (`recognize_cosine_window`). With output='power', onesided=True and a
    real signal this is `kernels.cuda_dft.fir_framed_dft_power_shared_cuda`
    (kernel D on a CUDA tensor, its plain version on a CPU one); otherwise
    the plain torch stages run. Every `precision` runs the same arithmetic:
    f32 operands, the contraction summed in f64 on the plain path
    (`_shared_partial_dfts`) and in two levels of f32 in kernel D.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.kernels.dft import fir_framed_dft, fir_framed_dft_shared
    >>> x = torch.sin(0.1 * torch.arange(1024.0))
    >>> taps = [0.25, 0.5, 0.25]
    >>> p = fir_framed_dft(x, taps, hann(256, device="cpu"), stride=64, n_fft=256, onesided=True,
    ...                    output='power')
    >>> ps = fir_framed_dft_shared(x, taps, stride=64, n_fft=256, window_coeffs=(0.5, -0.5),
    ...                            onesided=True, output='power')
    >>> bool((ps - p).abs().max() < 1e-4 * p.max())
    True
    """
    _check_precision(precision)
    if output not in ("complex", "power"):
        raise ValueError(f"output must be 'complex' or 'power', got {output!r}")
    if n_fft % stride != 0:
        raise ValueError(f"shared-block strategy needs stride | n_fft, got {stride}, {n_fft}")
    if onesided and n_fft % 2 != 0:
        raise ValueError("onesided shared-block strategy needs even n_fft")
    window_coeffs = tuple(float(b) for b in window_coeffs)
    if len(window_coeffs) < 1 or len(window_coeffs) > stride:
        raise ValueError("window_coeffs must have 1..stride terms")
    x = as_signal(x)
    length = x.shape[-1]
    if length < n_fft:
        raise ValueError(f"window length {n_fft} exceeds signal length {length}")
    num_frames = (length - n_fft) // stride + 1
    bins = n_fft // 2 + 1 if onesided else n_fft
    pad_left = 0 if taps is None else _same_pad_left(_host_f64(taps).size)
    weights = shared_fold_weights(taps, stride, n_fft, onesided, device=x.device)
    twiddles = shared_twiddles(stride, n_fft, onesided, device=x.device)
    if output == "power" and onesided and not x.is_complex():
        from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_shared_cuda

        return fir_framed_dft_power_shared_cuda(
            x, weights, twiddles, window_coeffs, stride=stride, pad_left=pad_left,
            num_frames=num_frames, bins=bins)
    p = _shared_partial_dfts(x, weights, stride=stride, pad_left=pad_left,
                             num_blocks=num_frames + n_fft // stride - 1, bins=bins)
    out_r, out_i = _shared_epilogue_torch(p, twiddles, window_coeffs,
                                          num_frames=num_frames, bins=bins,
                                          onesided=onesided)
    if output == "power":
        return out_r ** 2 + out_i ** 2
    return torch.complex(out_r, out_i)
