"""Parity of the port's analytic signal and envelope (hilbert, hilbert2,
envelope in nx_signal_tpu_torch/ops/transforms.py) with the JAX package's
(nx_signal_tpu/ops/transforms.py), on the CPU, with the same numpy inputs
made from a seed.

Tolerances, those of the JAX package's own tests against scipy
(tests/test_waveforms.py:121-126, tests/test_ltisys_surface.py:286-317):
f64 signals within 1e-10 absolute of the JAX result (and of scipy's);
float32 signals within 1e-5 of the max of the JAX result (two FFT
libraries, f32 sums in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import transforms as jt
from nx_signal_tpu_torch.ops import transforms as tt


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def signal(seed, shape, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def f64_close(got, want, oracle=None):
    got = got.numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-10)
    if oracle is not None:
        np.testing.assert_allclose(got, oracle, atol=1e-10)


@pytest.mark.parametrize("n", [100, 128, 999, 1024])
def test_hilbert_matches_jax(n):
    x = signal(1, n)
    f64_close(tt.hilbert(T(x)), jt.hilbert(x), sps.hilbert(x))


@pytest.mark.parametrize("n_fft,axis", [(None, 0), (64, -1), (77, -1), (40, 0)])
def test_hilbert_length_axis_and_float32(n_fft, axis):
    x = signal(2, (50, 3)) if axis == 0 else signal(2, (3, 50))
    f64_close(tt.hilbert(T(x), n=n_fft, axis=axis), jt.hilbert(x, n=n_fft, axis=axis),
              sps.hilbert(x, N=n_fft, axis=axis))
    x32 = x.astype(np.float32)
    got = tt.hilbert(T(x32), n=n_fft, axis=axis)
    want = np.asarray(jt.hilbert(jnp.asarray(x32), n=n_fft, axis=axis))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def test_hilbert_envelope_of_am_tone():
    """tests/test_waveforms.py:128-135: the magnitude of the analytic
    signal recovers an AM envelope."""
    t = np.arange(8000) / 8000
    msg = 1 + 0.5 * np.sin(2 * np.pi * 5 * t)
    x = (msg * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    env = tt.hilbert(T(x)).abs().numpy()
    np.testing.assert_allclose(env[200:-200], msg[200:-200], atol=1e-2)
    np.testing.assert_allclose(env, np.abs(np.asarray(jt.hilbert(x))), atol=1e-5)


@pytest.mark.parametrize("shape,n", [((8, 12), None), ((5, 7), None), ((6, 8), None),
                                     ((6, 9), (8, 12)), ((2, 5, 6), None), ((4, 4), 6)])
def test_hilbert2_matches_jax(shape, n):
    x = signal(3, shape)
    f64_close(tt.hilbert2(T(x), n=n), jt.hilbert2(x, n=n),
              sps.hilbert2(x, N=n) if len(shape) == 2 else None)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(bp_in=(5, 60)), dict(bp_in=(-40, 40)), dict(squared=True),
    dict(residual="all"), dict(residual=None), dict(n_out=150), dict(bp_in=(5, 60), n_out=100),
    dict(bp_in=(-60, -5)), dict(bp_in=(-50, 0), residual="all"), dict(n_out=451),
], ids=str)
def test_envelope_real_matches_jax(kwargs):
    x = signal(4, 300)
    bp = kwargs.pop("bp_in", (1, None))
    f64_close(tt.envelope(T(x), bp, **kwargs), jt.envelope(x, bp, **kwargs),
              sps.envelope(x, bp, **kwargs))


@pytest.mark.parametrize("kwargs", [dict(), dict(bp_in=(-30, 40)), dict(n_out=100),
                                    dict(n_out=333, residual="all")], ids=str)
def test_envelope_complex_matches_jax(kwargs):
    """A complex signal's residual goes through the port's Fourier
    `resample`, as the JAX package's does."""
    zc = signal(5, 200) + 1j * signal(6, 200)
    bp = kwargs.pop("bp_in", (1, None))
    f64_close(tt.envelope(T(zc), bp, **kwargs), jt.envelope(zc, bp, **kwargs),
              sps.envelope(zc, bp, **kwargs))


def test_envelope_axis_and_float32():
    x2 = signal(7, (4, 128))
    f64_close(tt.envelope(T(x2.T), axis=0), jt.envelope(x2.T, axis=0),
              sps.envelope(x2.T, axis=0))
    x32 = x2.astype(np.float32)
    got = tt.envelope(T(x32), n_out=64)
    want = np.asarray(jt.envelope(jnp.asarray(x32), n_out=64))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("call", [
    lambda m, a: m.hilbert(a(np.ones(4, np.complex128))),
    lambda m, a: m.hilbert2(a(np.ones(4))),
    lambda m, a: m.hilbert2(a(np.ones((4, 4), np.complex128))),
    lambda m, a: m.hilbert2(a(np.ones((4, 4))), n=(0, 3)),
    lambda m, a: m.envelope(a(np.ones(10)), (1, None), axis=2),
    lambda m, a: m.envelope(a(np.ones(10)), (1, 2, 3)),
    lambda m, a: m.envelope(a(np.ones(10)), (1, None), n_out=0),
    lambda m, a: m.envelope(a(np.ones(10)), (1, None), residual="x"),
    lambda m, a: m.envelope(a(np.ones(10)), (4, 2)),
])
def test_validation_messages_match_jax(call):
    with pytest.raises(ValueError) as jax_err:
        call(jt, jnp.asarray)
    with pytest.raises(ValueError) as port_err:
        call(tt, T)
    assert str(port_err.value) == str(jax_err.value)
