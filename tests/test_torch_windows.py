"""Parity of the port's windows (nx_signal_tpu_torch/ops/windows.py) with
the JAX package's, on the CPU: every name `get_window` takes, periodic and
symmetric, at lengths 1, 2, odd and even.

Tolerances: the windows built on the host in f64 numpy by the same
formulas on both sides are bitwise equal after the cast to float32
(general_cosine and its family, tukey, dpss, chebwin, taylor, ...); the
cosine-sum windows computed in float32 (hann, hamming, blackman) and
bartlett / triangular at 1e-6 absolute (float32 cos and division in two
libraries); kaiser and kaiser_bessel_derived at 2e-6 (the JAX package
evaluates I0 in float32, the port in f64 with numpy's i0, rounded once).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu_torch.ops import windows as tw

ts = importlib.import_module("nx_signal_tpu_torch.spectral.stft")

FLOAT32_NAMES = {"hann", "hamming", "blackman", "bartlett", "triangular", "triang"}
NAMES = sorted(set(jw._WINDOW_BUILDERS))
SPECS = [("kaiser", 8.0), ("kaiser", 0.5), ("gaussian", 2.5), ("general_gaussian", 1.5, 3.0),
         ("general_cosine", [0.5, 0.3, 0.2]), ("general_hamming", 0.6), ("tukey", 0.25),
         ("tukey", 0.0), ("tukey", 1.0), ("exponential", None, 3.0), ("taylor", 5, 40.0),
         ("chebwin", 60.0), ("dpss", 2.5)]
LENGTHS = [1, 2, 7, 16, 33]


def tolerance(spec):
    name = spec if isinstance(spec, str) else spec[0]
    if name in ("kaiser", "kaiser_bessel_derived"):
        return 2e-6
    return 1e-6 if name in FLOAT32_NAMES else 0.0


def check(spec, n, periodic, dtype=jnp.float32, tdtype=torch.float32):
    want = np.asarray(jw.get_window(spec, n, periodic=periodic, dtype=dtype))
    got = tw.get_window(spec, n, periodic=periodic, dtype=tdtype)
    assert got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tolerance(spec))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_named_windows_match_jax(name, periodic, n):
    check(name, n, periodic)


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n", [7, 16, 33])
def test_parametric_windows_match_jax(spec, periodic, n):
    if spec[0] == "exponential" and not periodic:
        spec = ("exponential",)  # an explicit center needs the periodic form
    if spec[0] == "dpss" and n == 1:
        return
    check(spec, n, periodic)


@pytest.mark.parametrize("n", [2, 8, 64])
def test_kaiser_bessel_derived_matches_jax(n):
    check(("kaiser_bessel_derived", 4.0), n, False)


@pytest.mark.parametrize("spec", ["rectangular", "boxcar"])
def test_rectangular_dtypes_match_jax(spec):
    check(spec, 5, False, dtype=jnp.int32, tdtype=torch.int32)
    assert tw.rectangular(4).dtype == torch.int32 and tw.boxcar(4).dtype == torch.float32
    np.testing.assert_array_equal(tw.rectangular(4).numpy(), np.asarray(jw.rectangular(4)))


def test_dpss_sequences_match_jax():
    want = np.asarray(jw.dpss(32, 3.0, 4, periodic=True))
    got = tw.dpss(32, 3.0, 4, periodic=True)
    assert got.shape == (4, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kaiser_eps_and_f64():
    np.testing.assert_allclose(tw.kaiser(9, beta=14.0, periodic=False, eps=1e-7).numpy(),
                               np.asarray(jw.kaiser(9, beta=14.0, periodic=False, eps=1e-7)),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(tw.kaiser(16, beta=8.0, dtype=torch.float64).numpy(),
                               np.kaiser(17, 8.0)[:16], rtol=1e-13, atol=0)


@pytest.mark.parametrize("call", [
    ("get_window", ("kaiser", 8), {}), ("get_window", ("nope", 8), {}),
    ("get_window", (("nope", 1.0), 8), {}),
    ("exponential", (6,), dict(center=2.0, periodic=False)), ("dpss", (8, 5.0), {}),
    ("dpss", (8, 1.0, 9), {}), ("kaiser_bessel_derived", (7, 4.0), {})], ids=str)
def test_window_errors_match_jax(call):
    name, args, kw = call
    with pytest.raises(ValueError) as want:
        getattr(jw, name)(*args, **kw)
    with pytest.raises(ValueError) as got:
        getattr(tw, name)(*args, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,nperseg,noverlap", [
    ("blackmanharris", 64, 48), ("flattop", 64, 48), (("kaiser", 6.0), 64, 32),
    ("bartlett", 64, 32), ("boxcar", 32, 0), (("tukey", 0.5), 64, 16), ("triang", 63, 40),
    ("hann", 64, 32), ("cosine", 64, 32)])
def test_check_cola_and_nola_take_every_named_window(spec, nperseg, noverlap):
    """check_cola / check_nola on a window name agree with scipy's checks of
    the JAX package's periodic f64 window of that name."""
    import scipy.signal as ss

    w = np.asarray(jw.get_window(spec, nperseg, periodic=True, dtype=jnp.float64))
    assert ts.check_cola(spec, nperseg, noverlap) == ss.check_COLA(w, nperseg, noverlap)
    assert ts.check_nola(spec, nperseg, noverlap) == ss.check_NOLA(w, nperseg, noverlap)
