"""Parity of the port's Lambert W (nx_signal_tpu_torch/ops/lambert_w.py)
with the JAX package's, on the CPU, with the same numpy inputs, at the
reference's gate in complex128: atol 1e-13, rtol 1e-10 (and against
scipy.special.lambertw, the JAX tests' oracle).
"""

import numpy as np
import pytest
import scipy.special as sp
import torch

from nx_signal_tpu.ops import lambert_w as jlw
from nx_signal_tpu_torch.ops import lambert_w as tlw

ATOL, RTOL = 1e-13, 1e-10
RE = np.array([-2.0, -0.5, -0.2, 0.3, 1.0, 5.0])
IM = np.array([-3.0, -0.4, 0.0, 0.4, 3.0])
GRID = (RE[:, None] + 1j * IM[None, :]).ravel()
# every input has GRID's length: the JAX package compiles its while_loop
# once per shape and branch, and the cases then share the compilations
REAL = np.resize([0.1, 0.5, 1.5, 2.0, 10.0, 100.0, 1e6], GRID.size)
NEAR = np.resize([-1 / np.e + 1e-3, -1 / np.e + 0.1, -0.3, -0.2, -0.1, -0.05], GRID.size)
EXTREMES = np.resize([1e-8, 1e8, 1e-300], GRID.size)


@pytest.mark.parametrize("k", [0, -1, 1, 2])
@pytest.mark.parametrize("z", [REAL, GRID, NEAR, EXTREMES],
                         ids=["real", "grid", "near-branch", "extremes"])
def test_lambert_w_matches_jax_and_scipy(z, k):
    got = tlw.lambert_w(torch.from_numpy(z.astype(np.complex128)), k)
    assert got.dtype == torch.complex128
    want = np.asarray(jlw.lambert_w(z.astype(np.complex128), k))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), sp.lambertw(z, k), atol=ATOL, rtol=RTOL)


def test_special_values_match_jax():
    z = np.resize(np.array([0.0, 1.0, np.inf, -np.inf, np.inf + 1j]), GRID.size)
    for k in (0, -1, 1):
        got = tlw.lambert_w(torch.from_numpy(z), k).numpy()
        want = np.asarray(jlw.lambert_w(z, k))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.isneginf(tlw.lambert_w(torch.tensor([0.0]), 1).numpy()[0].real)
    assert tlw.lambert_w(torch.tensor([1.0]), 0).numpy()[0] == jlw._OMEGA


def test_checking_every_few_steps_gives_the_same_bits(monkeypatch):
    """Frozen entries do not move: a check every step or every fourth gives
    the same bits, and a real input promotes to complex128."""
    z = torch.from_numpy(np.concatenate([GRID, NEAR]).astype(np.complex128))
    every_fourth = tlw.lambert_w(z, -1)
    monkeypatch.setattr(tlw, "_STEPS_PER_CHECK", 1)
    assert torch.equal(tlw.lambert_w(z, -1), every_fourth)
    assert tlw.lambert_w(torch.tensor([0.5], dtype=torch.float32)).dtype == torch.complex128
