"""Numerical-health checks (counterpart of nx_signal_tpu/utils/checks.py):
NaN/Inf guards to insert at a pipeline's seams while debugging."""

import torch

from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = ["assert_all_finite", "count_nonfinite"]


def count_nonfinite(x):
    """Number of NaN/Inf elements: a 0-d int64 tensor on x's device, with
    no sync (a complex element counts once when either part is not
    finite; an integer or bool tensor has none). `x` goes through
    `as_signal`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.checks import count_nonfinite
    >>> count_nonfinite(torch.tensor([1.0, float("inf"), float("nan")]))
    tensor(2)
    """
    x = as_signal(x)
    if not (x.is_floating_point() or x.is_complex()):
        return torch.zeros((), dtype=torch.int64, device=x.device)
    return (~torch.isfinite(x)).sum()


def assert_all_finite(x, name: str = "tensor"):
    """Return `x` unchanged, or raise FloatingPointError when it holds a NaN
    or an Inf. Reading the count is one device sync, where the JAX package
    defers the check through jax.debug.callback.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.checks import assert_all_finite
    >>> assert_all_finite(torch.tensor([1.0, 2.0]), "spectrum")
    tensor([1., 2.])
    >>> assert_all_finite(torch.tensor([1.0, float("nan")]), "spectrum")
    Traceback (most recent call last):
    ...
    FloatingPointError: spectrum contains 1 non-finite values
    """
    n = int(count_nonfinite(x))
    if n > 0:
        raise FloatingPointError(f"{name} contains {n} non-finite values")
    return x
