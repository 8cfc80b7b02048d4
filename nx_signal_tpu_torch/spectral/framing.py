"""Signal framing and overlap-add (counterpart of
nx_signal_tpu/spectral/framing.py).

* `as_windowed` is a strided view (`Tensor.unfold`), not a gather.
* `overlap_and_add` is not a scatter-add: `_ola_fold` is a left fold of the
  C = ceil(frame/stride) shifted (M, stride) blocks, so every output sample
  adds its contributing frames in strictly increasing frame order — the
  same association as the JAX fold, hence bitwise equal to it.
  `index_add_`, `scatter_add_` and atomics would lose that order.
"""

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["as_windowed", "overlap_and_add", "pad_for_windowing"]


def _frame_block_widths(window_length: int, stride: int):
    """Column widths of the C slice/reshape blocks."""
    num_blocks = -(-window_length // stride)  # ceil
    return [min(stride, window_length - r * stride) for r in range(num_blocks)]


def _padding_config(window_length: int, padding):
    """Resolve a padding spec to (lo, hi) zeros over the signal axis."""
    if padding == "valid":
        return (0, 0)
    if padding == "same":
        total = window_length - 1
        return (total // 2, total - total // 2)
    if isinstance(padding, (tuple, list)):
        if len(padding) == 1 and isinstance(padding[0], (tuple, list)):
            padding = padding[0]
        lo, hi = padding
        return (int(lo), int(hi))
    raise ValueError(
        "invalid padding mode specified, padding must be one of 'valid', 'same', "
        f"'reflect', or a (lo, hi) padding configuration, got: {padding}"
    )


def pad_for_windowing(x, window_length: int, padding):
    """Apply an `as_windowed` padding mode to the signal axis without
    framing it. 'reflect' follows numpy's mode (no edge duplication, and
    repeated reflection when the pad exceeds the signal).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.framing import pad_for_windowing
    >>> pad_for_windowing(torch.arange(6.0), window_length=4, padding='reflect')
    tensor([2., 1., 0., 1., 2., 3., 4., 5., 4., 3.])
    """
    x = as_signal(x)
    if padding == "reflect":
        half, n = window_length // 2, x.shape[-1]
        if n < 2:  # numpy's own rule (and error) for an axis this short
            idx = torch.as_tensor(np.pad(np.arange(n), (half, half), mode="reflect"),
                                  device=x.device)
        else:
            # numpy's reflection, periodic in 2(n - 1), built where the
            # signal is: no host-to-device copy a call
            j = torch.remainder(torch.arange(-half, n + half, device=x.device), 2 * (n - 1))
            idx = torch.where(j < n, j, 2 * (n - 1) - j)
        return x.index_select(-1, idx)
    lo, hi = _padding_config(window_length, padding)
    if lo < 0 or hi < 0:
        raise ValueError(f"padding must be non-negative, got: ({lo}, {hi})")
    if lo or hi:
        return F.pad(x, (lo, hi))
    return x


def as_windowed(x, *, window_length: int, stride: int = 1, padding="valid"):
    """Frame a signal into overlapping windows: (..., L) -> (..., M, window_length),
    M = (L_padded - window_length)//stride + 1. Padding modes as in
    `pad_for_windowing`: 'valid', 'same', (lo, hi) or 'reflect'. Returns a
    strided view of the (padded) signal.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.framing import as_windowed
    >>> as_windowed(torch.arange(8), window_length=4, stride=2)
    tensor([[0, 1, 2, 3],
            [2, 3, 4, 5],
            [4, 5, 6, 7]])
    """
    if stride < 1:
        raise ValueError(f"expected an integer >= 1 for stride, got: {stride}")
    x = pad_for_windowing(x, window_length, padding)
    if x.shape[-1] < window_length:
        raise ValueError(
            f"window length {window_length} exceeds padded signal length {x.shape[-1]}"
        )
    return x.unfold(-1, window_length, stride)


def _ola_seed(init, batch, length: int, dtype):
    """The (*batch, length) seed of a fold: `init` cut to `length` samples
    and zero-padded to it, in `dtype`."""
    init = torch.as_tensor(init)
    if tuple(init.shape[:-1]) != tuple(batch):
        raise ValueError(f"init must have the frames' batch shape {tuple(batch)}, "
                         f"got {tuple(init.shape[:-1])}")
    init = init[..., :length].to(dtype)
    return F.pad(init, (0, length - init.shape[-1]))


def _part_seeds(init):
    """The (real part, imaginary part) seeds of a complex fold: a complex
    seed's parts, a real seed for the real part only, or none."""
    if init is None:
        return None, None
    init = torch.as_tensor(init)
    return (init.real, init.imag) if init.is_complex() else (init, None)


def _ola_fold_torch(frames, stride: int, out_length: int, init=None):
    """Plain deterministic overlap-add: a left fold of the C shifted blocks,
    j descending, so sample p = q*stride + s receives frames[q - j,
    s + j*stride] in increasing frame order.

    The (rows, stride) accumulator grid starts at `init` (cut to
    rows*stride samples, zero-padded), or at +0.0 without one, and every
    block is added to the whole grid, zeros outside its row range, as the
    JAX fold does: a seed of -0.0 then meets the same +0.0 terms.

    Complex frames fold their real and imaginary parts apart: torch's
    complex add computes a + 1*b, and the complex product 1*b turns a real
    part of -0.0 into +0.0 where the imaginary part is negative."""
    if frames.is_complex():
        seeds = _part_seeds(init)
        re = _ola_fold_torch(frames.real, stride, out_length, init=seeds[0])
        im = _ola_fold_torch(frames.imag, stride, out_length, init=seeds[1])
        return torch.complex(re, im)
    *batch, num_frames, window_length = frames.shape
    widths = _frame_block_widths(window_length, stride)
    num_rows = -(-out_length // stride)
    grid = (*batch, num_rows, stride)
    if init is None:
        acc = torch.zeros(grid, dtype=frames.dtype, device=frames.device)
    else:
        acc = _ola_seed(init, batch, num_rows * stride, frames.dtype).reshape(grid)
        acc = acc.to(frames.device, copy=True)
    block = torch.empty_like(acc)
    for j in range(len(widths) - 1, -1, -1):
        rows = max(min(num_frames, num_rows - j), 0)
        w = widths[j]
        block.zero_()
        block[..., j:j + rows, :w] = frames[..., :rows, j * stride:j * stride + w]
        acc += block
    return acc.reshape(*batch, num_rows * stride)[..., :out_length]


def _ola_fold(frames, stride: int, out_length: int, init=None):
    """Deterministic overlap-add of (..., M, N) frames into (..., out_length).
    `init` (..., any length), if given, seeds the accumulator: a sample
    receiving frames m0 < m1 < ... is (((init + f_m0) + f_m1) + ...) with
    exactly that association, which the sharded overlap-add
    (parallel/sharded.py:sharded_istft) needs to stay bitwise.

    float32 frames go through `kernels.cuda_dft.overlap_add_cuda` (the
    hand-written kernel on a CUDA tensor, its plain version on a CPU one),
    and complex64 frames through it once per part, seeded by the seed's
    parts (a real seed seeds the real part only), as `_ola_fold_torch`
    folds them; other dtypes take the plain fold."""
    if frames.dtype in (DEFAULT_FLOAT, torch.complex64):
        from nx_signal_tpu_torch.kernels import cuda_dft

        if frames.dtype == DEFAULT_FLOAT:
            return cuda_dft.overlap_add_cuda(frames, stride=stride, out_length=out_length,
                                             init=init)
        re, im = (cuda_dft.overlap_add_cuda(part.contiguous(), stride=stride,
                                            out_length=out_length, init=seed)
                  for part, seed in zip((frames.real, frames.imag), _part_seeds(init)))
        return torch.complex(re, im)
    return _ola_fold_torch(frames, stride, out_length, init=init)


def overlap_and_add(frames, *, overlap_length: int, dtype=None):
    """Overlap-add an (..., M, N) stack of frames into an
    (..., M*stride + overlap_length) signal, stride = N - overlap_length,
    accumulating each output sample in increasing frame order.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.spectral.framing import overlap_and_add
    >>> frames = torch.tensor([[1, 1, 1, 1], [10, 10, 10, 10], [100, 100, 100, 100]])
    >>> overlap_and_add(frames, overlap_length=2)
    tensor([  1,   1,  11,  11, 110, 110, 100, 100])
    """
    frames = as_signal(frames)
    if frames.ndim < 2:
        raise ValueError(f"expected a tensor of rank >= 2, got rank {frames.ndim}")
    num_frames, window_length = frames.shape[-2], frames.shape[-1]
    if overlap_length >= window_length:
        raise ValueError(
            "overlap_length must be a number less than the window size "
            f"{window_length}, got: {overlap_length}"
        )
    stride = window_length - overlap_length
    out = _ola_fold(frames, stride, num_frames * stride + overlap_length)
    if dtype is not None:
        out = out.to(dtype)
    return out
