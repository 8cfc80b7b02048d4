"""N-D FFT helpers with per-axis length control (counterpart of
nx_signal_tpu/ops/transforms.py: the part that ops/convolution.py uses),
on torch.fft. Each axis listed in `axes` is padded or truncated to the
matching entry of `lengths`.
"""

import torch

from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = ["fft_nd", "ifft_nd", "rfft_nd", "irfft_nd"]


def _norm_axes_lengths(x, axes, lengths):
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(int(a) % x.ndim for a in axes)
    if lengths is not None:
        lengths = tuple(int(n) for n in lengths)
        if len(lengths) != len(axes):
            raise ValueError(
                f"lengths must match axes, got {len(lengths)} lengths for {len(axes)} axes")
    return axes, lengths


def fft_nd(x, *, axes=None, lengths=None):
    """Forward FFT over `axes`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.transforms import fft_nd
    >>> X = fft_nd(torch.ones((2, 4)), axes=[0, 1], lengths=[2, 8])
    >>> X.shape, X.dtype
    (torch.Size([2, 8]), torch.complex64)
    """
    x = as_signal(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return torch.fft.fftn(x, s=lengths, dim=axes)


def ifft_nd(x, *, axes=None, lengths=None):
    """Inverse FFT over `axes`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.transforms import fft_nd, ifft_nd
    >>> X = fft_nd(torch.ones((2, 4)), axes=[1], lengths=[4])
    >>> ifft_nd(X, axes=[1]).real
    tensor([[1., 1., 1., 1.],
            [1., 1., 1., 1.]])
    """
    x = as_signal(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return torch.fft.ifftn(x, s=lengths, dim=axes)


def rfft_nd(x, *, axes=None, lengths=None):
    """Real-input forward FFT over `axes`, half spectrum on the last of
    them.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.transforms import rfft_nd
    >>> R = rfft_nd(torch.ones((2, 8)), axes=[1])
    >>> R.shape, R.dtype
    (torch.Size([2, 5]), torch.complex64)
    """
    x = as_signal(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return torch.fft.rfftn(x, s=lengths, dim=axes)


def irfft_nd(x, *, axes=None, lengths=None):
    """Inverse of `rfft_nd`; `lengths` are the full (time-domain) lengths.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.transforms import irfft_nd, rfft_nd
    >>> y = irfft_nd(rfft_nd(torch.ones((2, 8)), axes=[1]), axes=[1], lengths=[8])
    >>> y.shape, y.dtype
    (torch.Size([2, 8]), torch.float32)
    """
    x = as_signal(x)
    axes, lengths = _norm_axes_lengths(x, axes, lengths)
    return torch.fft.irfftn(x, s=lengths, dim=axes)
