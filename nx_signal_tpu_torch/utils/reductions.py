"""Reductions whose numpy and jax.numpy meaning torch does not give.
Below ops and spectral: both import it."""

import torch


def _median_last(t, dims: int = 1):
    """Median over the last `dims` axes: the middle value of the sorted
    samples, or the mean of the two middle ones for an even count (numpy's
    and jnp's median; `torch.median` returns the lower one, and
    `torch.quantile` refuses more than 2^24 elements). NaN wherever the
    slice holds a NaN, as numpy and jnp give it (`torch.sort` puts NaN
    last, so the middle values alone would hide it).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.reductions import _median_last
    >>> _median_last(torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 7.0, 6.0, 0.0]]))
    tensor([2.5000, 5.5000])
    >>> _median_last(torch.tensor([1.0, float("nan"), 3.0]))
    tensor(nan)
    """
    flat = t.reshape(*t.shape[:t.ndim - dims], -1)
    count = flat.shape[-1]
    vals = torch.sort(flat, dim=-1).values
    mid = count // 2
    if count % 2:
        out = vals[..., mid]
    else:
        out = (vals[..., mid - 1] + vals[..., mid]) * 0.5
    last = vals[..., -1]
    return torch.where(torch.isnan(last), last, out)
