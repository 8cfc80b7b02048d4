"""Relative-extrema peak finding (counterpart of
nx_signal_tpu/ops/peak_finding.py): argrelmin, argrelmax, argrelextrema.

Results keep the JAX package's fixed-shape encoding: an (n, rank) int32
index tensor, the valid rows first in row-major order and the rest -1,
plus the count of valid rows. The JAX package front-packs the rows with a
stable sort of the mask; `torch.nonzero` gives the same rows in the same
order (one device sync for the count).
"""

from typing import NamedTuple

import torch

from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = ["argrelmin", "argrelmax", "argrelextrema", "Extrema"]


class Extrema(NamedTuple):
    """indices: (n, rank) int32, -1-padded after the first `valid_indices`
    rows (rows in row-major scan order); valid_indices: a 0-d int64 tensor
    (uint32 in the JAX package, a dtype torch's indexing and reductions do
    not take), the same value."""

    indices: torch.Tensor
    valid_indices: torch.Tensor


def argrelmin(data, *, axis: int = 0, order: int = 1):
    """Relative minima along `axis` with neighbourhood `order`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.peak_finding import argrelmin
    >>> idx, count = argrelmin(torch.tensor([3.0, 1.0, 4.0, 0.0, 5.0]))
    >>> idx.ravel()[:2], int(count)
    (tensor([1, 3], dtype=torch.int32), 2)
    """
    return argrelextrema(data, torch.less, axis=axis, order=order)


def argrelmax(data, *, axis: int = 0, order: int = 1):
    """Relative maxima along `axis` with neighbourhood `order`.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.peak_finding import argrelmax
    >>> r = argrelmax(torch.tensor([1.0, 3.0, 2.0, 5.0, 2.0, 0.0]))
    >>> r.indices.ravel()
    tensor([ 1,  3, -1, -1, -1, -1], dtype=torch.int32)
    >>> r.valid_indices
    tensor(2)
    """
    return argrelextrema(data, torch.greater, axis=axis, order=order)


def argrelextrema(data, comparator, *, axis: int = 0, order: int = 1):
    """Comparator-based relative extrema: the element at i is kept iff
    comparator(x[i], x[i ± s]) holds for every shift s in 1..order, the
    neighbour indices clamped at the edges. `comparator` is a function of
    two tensors (torch.greater, torch.less_equal, ...).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.peak_finding import argrelextrema
    >>> ext = argrelextrema(torch.tensor([1.0, 3.0, 2.0, 5.0, 4.0, 6.0, 0.0]), torch.greater)
    >>> ext.indices[:4, 0], int(ext.valid_indices)   # -1 pads the fixed shape
    (tensor([ 1,  3,  5, -1], dtype=torch.int32), 3)
    """
    data = as_signal(data)
    return _nonzero(_boolrelextrema(data, comparator, axis, order))


def _boolrelextrema(data, comparator, axis, order):
    length = data.shape[axis]
    locs = torch.arange(length, device=data.device)
    results = torch.ones(data.shape, dtype=torch.bool, device=data.device)
    for shift in range(1, order + 1):
        plus = torch.index_select(data, axis, torch.clamp(locs + shift, 0, length - 1))
        minus = torch.index_select(data, axis, torch.clamp(locs - shift, 0, length - 1))
        results &= comparator(data, plus) & comparator(data, minus)
    return results


def _nonzero(mask):
    """Boolean mask -> Extrema: the index rows of the True elements in
    row-major order, then rows of -1 up to mask.numel()."""
    found = torch.nonzero(mask).to(torch.int32)
    indices = torch.full((mask.numel(), mask.ndim), -1, dtype=torch.int32, device=mask.device)
    indices[:found.shape[0]] = found
    return Extrema(indices=indices,
                   valid_indices=torch.tensor(found.shape[0], device=mask.device))
