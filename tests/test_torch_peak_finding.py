"""Parity of the port's relative extrema (argrelmin / argrelmax /
argrelextrema in nx_signal_tpu_torch/ops/peak_finding.py) with the JAX
package's, on the CPU, with the same numpy inputs made from a seed: the
-1-padded (n, rank) int32 index rows equal, row for row, and the same
count (uint32 in the JAX package, an int64 tensor in the port).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import peak_finding as jp
from nx_signal_tpu_torch.ops import peak_finding as tp

_RNG = np.random.default_rng(0)
X1 = _RNG.normal(size=257).astype(np.float32)
X2 = np.round(_RNG.normal(size=(6, 40)) * 2).astype(np.float32)  # ties
X3 = _RNG.normal(size=(3, 5, 7))


def same(got, want):
    assert got.indices.dtype == torch.int32 and got.valid_indices.dtype == torch.int64
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert int(got.valid_indices) == int(want.valid_indices)


@pytest.mark.parametrize("x,axis", [(X1, 0), (X2, 0), (X2, 1), (X3, 0), (X3, 1), (X3, -1)])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("name", ["argrelmin", "argrelmax"])
def test_argrel_matches_jax(name, x, axis, order):
    got = getattr(tp, name)(torch.from_numpy(x), axis=axis, order=order)
    same(got, getattr(jp, name)(x, axis=axis, order=order))


@pytest.mark.parametrize("port_cmp,jax_cmp", [(torch.greater_equal, jnp.greater_equal),
                                              (torch.less_equal, jnp.less_equal),
                                              (torch.greater, jnp.greater)])
def test_argrelextrema_comparators_match_jax(port_cmp, jax_cmp):
    for x, axis in [(X2, 1), (X2, 0), (np.array([2, 1, 2, 3, 2, 0, 1, 0]), 0)]:
        same(tp.argrelextrema(torch.from_numpy(x), port_cmp, axis=axis, order=2),
             jp.argrelextrema(x, jax_cmp, axis=axis, order=2))


def test_argrelmax_rows_are_scipys():
    got = tp.argrelmax(torch.from_numpy(X2), axis=1, order=2)
    rows, cols = sps.argrelmax(X2, axis=1, order=2)
    count = int(got.valid_indices)
    np.testing.assert_array_equal(got.indices[:count].numpy(), np.stack([rows, cols], 1))
    assert (got.indices[count:] == -1).all()
