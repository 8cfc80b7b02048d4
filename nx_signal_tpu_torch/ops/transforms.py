"""N-D FFT helpers with per-axis length control, the analytic signal and
the envelope (counterpart of nx_signal_tpu/ops/transforms.py), on
torch.fft. Each axis listed in `axes` is padded or truncated to the
matching entry of `lengths`.
"""

import numpy as np
import torch

from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = ["fft_nd", "ifft_nd", "rfft_nd", "irfft_nd", "hilbert", "hilbert2", "envelope"]


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


def hilbert(x, *, n: int = None, axis: int = -1):
    """Analytic signal by the FFT method (scipy.signal.hilbert semantics):
    real input -> complex output whose real part is x and imaginary part
    its Hilbert transform; |hilbert(x)| is the envelope. `n` (the FFT
    length) defaults to the signal length.

    Examples:

    The envelope of a full-period cosine is exactly 1:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.transforms import hilbert
    >>> hilbert(torch.cos(2 * torch.pi * torch.arange(8.0) / 8)).abs().numpy().round(4)
    array([1., 1., 1., 1., 1., 1., 1., 1.], dtype=float32)
    """
    x = as_signal(x)
    if x.is_complex():
        raise ValueError("hilbert requires a real input signal")
    n_fft = int(n) if n is not None else x.shape[axis]
    spectrum = torch.fft.fft(x, n=n_fft, dim=axis)
    h = torch.zeros(n_fft, dtype=spectrum.real.dtype, device=x.device)
    h[0] = 1.0
    if n_fft % 2 == 0:
        h[n_fft // 2] = 1.0
        h[1:n_fft // 2] = 2.0
    else:
        h[1:(n_fft + 1) // 2] = 2.0
    shape = [1] * x.ndim
    shape[axis] = n_fft
    return torch.fft.ifft(spectrum * h.reshape(shape), dim=axis)


def hilbert2(x, *, n=None):
    """2-D analytic signal over the last two axes, scipy.signal.hilbert2
    semantics: fft2, zero the negative-frequency half-planes (doubling the
    positive ones), ifft2. `n` is an optional (n0, n1) FFT shape, or one
    int for both. Real input required.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.transforms import hilbert2
    >>> hilbert2(torch.ones((4, 4))).shape
    torch.Size([4, 4])
    """
    x = as_signal(x)
    if x.is_complex():
        raise ValueError("x must be real")
    if x.ndim < 2:
        raise ValueError("x must have at least 2 dimensions")
    if n is None:
        shape = (x.shape[-2], x.shape[-1])
    else:
        shape = (int(n), int(n)) if np.ndim(n) == 0 else (int(n[0]), int(n[1]))
        if shape[0] < 1 or shape[1] < 1:
            raise ValueError("n must be positive")
    zf = torch.fft.fft2(x, s=shape, dim=(-2, -1))

    def half_filter(m):
        # single-orthant factor (1 + s_N): DC 1, strictly-positive bins
        # below Nyquist 2, Nyquist AND negative bins 0; scipy zeroes the
        # even-N Nyquist bin here (unlike 1-D hilbert, which keeps it at 1)
        h = torch.zeros((m,), dtype=zf.real.dtype, device=x.device)
        h[0] = 1.0
        h[1:(m + 1) // 2] = 2.0
        return h

    h = half_filter(shape[0])[:, None] * half_filter(shape[1])[None, :]
    return torch.fft.ifft2(zf * h, dim=(-2, -1))


def envelope(z, bp_in=(1, None), *, n_out=None, squared=False, residual="lowpass", axis=-1):
    """Envelope (and residual) of a signal, scipy.signal.envelope
    semantics: band-limit the spectrum to the `bp_in` bin range, take the
    analytic (baseband) magnitude as the envelope (optionally squared,
    optionally resampled to `n_out`), and return the out-of-band rest as
    the residual ('lowpass' keeps only bins below the band; 'all' keeps
    everything outside; None returns just the envelope). Returns the
    envelope alone, or stack([envelope, residual]) along a new axis 0. A
    complex signal's residual goes through `ops.resample.resample`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.transforms import envelope
    >>> out = envelope(torch.sin(2 * torch.pi * 0.1 * torch.arange(32.0)))
    >>> out.shape
    torch.Size([2, 32])
    >>> out[0, :3].numpy().round(4)
    array([0.3119, 0.9088, 0.9576], dtype=float32)
    """
    z = as_signal(z)
    if not (-z.ndim <= axis < z.ndim):
        raise ValueError(f"Invalid parameter axis={axis} for z.shape={tuple(z.shape)}!")
    if z.shape[axis] <= 0:
        raise ValueError(f"z.shape[axis] not > 0 for z.shape={tuple(z.shape)}")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, int) for b in bp_in):
        raise ValueError(f"bp_in={bp_in!r} isn't a 2-tuple of (int | None)")
    if n_out is not None and (not isinstance(n_out, int) or n_out <= 0):
        raise ValueError(f"n_out={n_out!r} is not a positive integer or None")
    if residual not in ("lowpass", "all", None):
        raise ValueError(f"residual={residual!r} not in ['lowpass', 'all', None]")

    n = z.shape[axis]
    n_out = n if n_out is None else n_out
    fak = n_out / n
    lo = bp_in[0] if bp_in[0] is not None else -(n // 2)
    hi = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not (-(n // 2) <= lo < hi <= (n + 1) // 2):
        raise ValueError(f"-n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2 does not "
                         f"hold for n={n} and bp_in={bp_in}")

    z = torch.movedim(z, axis, -1)
    complex_input = z.is_complex()
    if complex_input:
        zf = torch.fft.fft(z)
    else:
        half = torch.fft.rfft(z)
        zf = torch.zeros(z.shape, dtype=half.dtype, device=z.device)
        zf[..., :n // 2 + 1] = half
        # make the in-band signal analytic (double positive-frequency bins)
        if lo > 0:
            zf[..., lo:hi] *= 2
        elif hi > 0:
            zf[..., 1:hi] *= 2

    if not (lo <= 0 < hi):
        z_bb = torch.fft.ifft(zf[..., lo:hi], n=n_out) * fak
    else:
        shifted = torch.fft.fftshift(zf, dim=-1)
        z_bb = torch.fft.ifft(shifted[..., lo + n // 2:hi + n // 2], n=n_out) * fak
    env = (z_bb.real ** 2 + z_bb.imag ** 2) if squared else z_bb.abs()
    env = torch.movedim(env, -1, axis)
    if residual is None:
        return env

    # zero the in-band bins, then (for 'lowpass') everything above the band
    if not (lo <= 0 < hi):
        zf[..., lo:hi] = 0
    else:
        zf[..., :hi] = 0
        zf[..., lo:] = 0
    if residual == "lowpass":
        if hi > 0:
            zf[..., hi:(n + 1) // 2] = 0
        else:
            zf[..., lo:] = 0
            zf[..., 0:(n + 1) // 2] = 0
    if complex_input:
        from nx_signal_tpu_torch.ops.resample import resample

        z_res = resample(torch.fft.ifft(zf), n_out, axis=-1)
    else:
        m = min(n, n_out)
        if n_out != n and m % 2 == 0:
            zf[..., m // 2] *= 2.0 if n_out < n else 0.5
        z_res = fak * torch.fft.irfft(zf, n=n_out)
    return torch.stack((env, torch.movedim(z_res, -1, axis)), dim=0)

