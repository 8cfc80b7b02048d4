"""Parity of the port's wavelets (nx_signal_tpu_torch/ops/wavelets.py) with
the JAX package's, on the CPU, with the same numpy inputs made from a seed.

The wavelet tables are the same host f64 math cast once (1e-7). `cwt` is
one FFT of the data and one batched FFT of the bank at the same
power-of-two length in both packages; held at the JAX tests' gate, atol
2e-5 and rtol 1e-4. The host f64 `_cwt_f64` (find_peaks_cwt's) at 1e-12.
"""

import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import wavelets as jwv
from nx_signal_tpu_torch.ops import wavelets as twv

_RNG = np.random.default_rng(0)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("points,a", [(5, 1.0), (100, 4.0), (33, 2.5), (7.5, 1.5)])
def test_ricker_matches_jax(points, a):
    got = twv.ricker(points, a, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jwv.ricker(points, a)), atol=1e-7)
    np.testing.assert_allclose(twv.ricker(points, a, dtype=torch.float64, device="cpu").numpy(),
                               jwv._ricker_np(points, a), atol=1e-15)


@pytest.mark.parametrize("points,w,s,complete", [(5, 5.0, 0.5, True), (64, 6.0, 1.0, False),
                                                 (31, 3.0, 2.0, True)])
def test_morlet_and_morlet2_match_jax(points, w, s, complete):
    got = twv.morlet(points, w, s, complete, device="cpu")
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(jwv.morlet(points, w, s, complete)),
                               atol=1e-7)
    np.testing.assert_allclose(twv.morlet2(points, s, w, device="cpu").numpy(),
                               np.asarray(jwv.morlet2(points, s, w)), atol=1e-7)


def test_qmf_matches_jax():
    hk = _RNG.normal(size=9)
    np.testing.assert_array_equal(twv.qmf(hk, device="cpu").numpy(), np.asarray(jwv.qmf(hk)))
    np.testing.assert_array_equal(twv.qmf(T(hk.astype(np.float32))).numpy(),
                                  np.asarray(jwv.qmf(hk.astype(np.float32))))
    with pytest.raises(ValueError, match="rank-1"):
        twv.qmf(np.ones((2, 2)))


@pytest.mark.parametrize("wavelet,widths,complex_data", [
    ("ricker", np.arange(1, 11), False), ("ricker", [0.5, 2.0, 7.25], False),
    ("morlet2", np.arange(1, 7), False), ("ricker", np.arange(1, 8), True),
    ("ricker", [60.0], False)])
def test_cwt_matches_jax(wavelet, widths, complex_data):
    n = 300
    data = _RNG.normal(size=n).astype(np.float32)
    if complex_data:
        data = (data + 1j * _RNG.normal(size=n)).astype(np.complex64)
    got = twv.cwt(T(data), getattr(twv, wavelet), widths)
    want = np.asarray(jwv.cwt(data, getattr(jwv, wavelet), widths))
    assert tuple(got.shape) == want.shape
    assert got.dtype == (torch.complex64 if want.dtype == np.complex64 else torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_cwt_dtype_host_wavelet_and_errors():
    data = _RNG.normal(size=128)
    got = twv.cwt(T(data), jwv._ricker_np, np.arange(1, 6), dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(jwv.cwt(data, jwv._ricker_np,
                                                               np.arange(1, 6))),
                               atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="rank-1"):
        twv.cwt(T(np.ones((2, 8))), twv.ricker, [1.0])
    with pytest.raises(ValueError, match="empty wavelet"):
        twv.cwt(T(np.ones(8)), twv.ricker, [0.0])


def test_cwt_f64_matches_jax():
    data = _RNG.normal(size=200)
    widths = np.arange(1, 12, dtype=np.float64)
    np.testing.assert_allclose(twv._cwt_f64(T(data), twv._ricker_np, widths),
                               jwv._cwt_f64(data, jwv._ricker_np, widths), rtol=0, atol=1e-12)
