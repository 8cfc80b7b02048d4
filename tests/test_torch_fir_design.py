"""Parity of the port's FIR design (nx_signal_tpu_torch/ops/fir_design.py)
with the JAX package's, on the CPU.

Both compute in f64 numpy on the host; the port returns a torch tensor of
`dtype` on `device`. Tolerances, the gates of tests/test_fir_design.py:
kaiser_beta, kaiser_atten and kaiserord 1e-12; firwin2 1e-10 (its Kaiser
window 1e-6: the JAX package's f64 Kaiser differs from numpy's i0 by up to
2.3e-6 at beta 40, ROADMAP "Kaiser in f64"); firls 1e-7 absolute and 1e-6
relative; remez 1e-10 between the packages (the same exchange in f64), and
both within 2e-3 of scipy; minimum_phase 1e-8. float32 outputs (the
default dtype) within 1e-6 of the max; the error messages the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import fir_design as jf
from nx_signal_tpu_torch.ops import fir_design as tf

FIRWIN2_CASES = [
    (129, [0.0, 0.3, 0.5, 1.0], [1.0, 1.0, 0.0, 0.0], {}),
    (128, [0.0, 0.3, 0.5, 1.0], [1.0, 1.0, 0.0, 0.0], {}),
    (65, [0.0, 0.2, 0.2, 0.6, 0.6, 1.0], [0.0, 0.0, 1.0, 1.0, 0.0, 0.0], {}),
    (101, [0.0, 0.5, 1.0], [0.0, 1.0, 0.0], dict(antisymmetric=True)),
    (100, [0.0, 0.5, 1.0], [0.0, 1.0, 1.0], dict(antisymmetric=True)),
    (65, [0.0, 2000.0, 3000.0, 8000.0], [1.0, 1.0, 0.0, 0.0], dict(sampling_rate=16000.0)),
    (64, [0.0, 0.4, 1.0], [1.0, 0.5, 0.0], dict(window="blackman", nfreqs=513)),
]
FIRLS_CASES = [
    (11, [0, 0.1, 0.4, 0.5], [1, 1, 0, 0], None, {}),
    (31, [0, 0.2, 0.3, 0.8, 0.9, 1.0], [0, 0, 1, 1, 0, 0], [1.0, 2.0, 0.5], {}),
    (101, [0, 0.5, 0.55, 1.0], [1, 0.8, 0, 0], None, {}),
    (31, [0, 1000, 2000, 8000], [1, 1, 0, 0], None, dict(sampling_rate=16000.0)),
]
REMEZ_CASES = [
    (72, [0, 0.1, 0.2, 0.5], [1, 0], [1.0, 1.0]),
    (73, [0, 0.1, 0.2, 0.5], [1, 0], [1.0, 1.0]),
    (65, [0, 0.1, 0.15, 0.35, 0.4, 0.5], [0, 1, 0], [1.0, 1.0, 1.0]),
    (21, [0, 0.2, 0.3, 0.5], [1, 0], [1.0, 2.0]),
    (18, [0, 0.15, 0.3, 0.5], [1, 0], [1.0, 1.0]),
]


def close(got, want, atol, rtol=0.0, dtype=torch.float64):
    assert isinstance(got, torch.Tensor) and got.dtype == dtype and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def f32_close(got, want):
    assert got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("ripple,width", [(65, 0.05), (21.5, 0.1), (30, 0.02), (80, 0.08)])
def test_kaiser_sizing_matches_jax(ripple, width):
    assert tf.kaiserord(ripple, width) == jf.kaiserord(ripple, width)
    assert tf.kaiser_beta(ripple) == pytest.approx(jf.kaiser_beta(ripple), abs=1e-12)
    assert tf.kaiser_atten(101, width) == pytest.approx(jf.kaiser_atten(101, width), abs=1e-12)
    assert tf.kaiser_beta(10) == 0.0
    with pytest.raises(ValueError, match="too small"):
        tf.kaiserord(5, 0.1)


@pytest.mark.parametrize("nt,f,g,kw", FIRWIN2_CASES)
def test_firwin2_matches_jax(nt, f, g, kw):
    want = jf.firwin2(nt, f, g, dtype=jnp.float64, **kw)
    close(tf.firwin2(nt, f, g, dtype=torch.float64, device="cpu", **kw), want, 1e-10, 1e-10)
    f32_close(tf.firwin2(nt, f, g, device="cpu", **kw), want)


def test_firwin2_kaiser_window_matches_jax():
    want = jf.firwin2(33, [0.0, 1.0], [1.0, 0.0], window=("kaiser", 8.0), dtype=jnp.float64)
    close(tf.firwin2(33, [0.0, 1.0], [1.0, 0.0], window=("kaiser", 8.0), dtype=torch.float64,
                     device="cpu"), want, 1e-6)


@pytest.mark.parametrize("nt,b,d,w,kw", FIRLS_CASES)
def test_firls_matches_jax(nt, b, d, w, kw):
    want = jf.firls(nt, b, d, weight=w, dtype=jnp.float64, **kw)
    close(tf.firls(nt, b, d, weight=w, dtype=torch.float64, device="cpu", **kw), want, 1e-7,
          1e-6)
    f32_close(tf.firls(nt, b, d, weight=w, device="cpu", **kw), want)


@pytest.mark.parametrize("nt,b,d,w", REMEZ_CASES)
def test_remez_matches_jax(nt, b, d, w):
    want = jf.remez(nt, b, d, weight=w, sampling_rate=1.0, dtype=jnp.float64)
    got = tf.remez(nt, b, d, weight=w, sampling_rate=1.0, dtype=torch.float64, device="cpu")
    close(got, want, 1e-10)
    np.testing.assert_allclose(got.numpy(), sps.remez(nt, b, d, weight=w, fs=1.0), atol=2e-3)
    f32_close(tf.remez(nt, b, d, weight=w, sampling_rate=1.0, device="cpu"), want)


@pytest.mark.parametrize("half", [True, False])
def test_minimum_phase_matches_jax(half):
    h = sps.remez(151, [0, 0.2, 0.3, 0.5], [1, 0], fs=1.0)
    want = jf.minimum_phase(h, half=half, dtype=jnp.float64)
    close(tf.minimum_phase(h, half=half, dtype=torch.float64, device="cpu"), want, 1e-8)
    # a tensor's taps in, the same taps out, on the tensor's device
    close(tf.minimum_phase(torch.from_numpy(h), half=half, dtype=torch.float64), want, 1e-8)
    f32_close(tf.minimum_phase(h, half=half, n_fft=4096, device="cpu"), jf.minimum_phase(
        h, half=half, n_fft=4096, dtype=jnp.float64))


def test_taps_go_to_the_device_asked():
    """Design functions return taps on `device` (the card when none is
    named, tests/test_torch_devices.py), as ops.filters.firwin."""
    for taps in (tf.firwin2(9, [0.0, 1.0], [1.0, 0.0], device="cpu"),
                 tf.firls(9, [0, 0.4, 0.5, 1.0], [1, 1, 0, 0], device=torch.device("cpu")),
                 tf.remez(9, [0, 0.2, 0.3, 0.5], [1, 0], sampling_rate=1.0, device="cpu"),
                 tf.minimum_phase([0.25, 0.5, 0.25], device="cpu")):
        assert taps.device.type == "cpu" and taps.dtype == torch.float32
    meta = tf.firls(9, [0, 0.4, 0.5, 1.0], [1, 1, 0, 0], device="meta")
    assert meta.device.type == "meta" and tuple(meta.shape) == (9,)


@pytest.mark.parametrize("call", [
    lambda m: m.firwin2(65, [0.1, 1.0], [1.0, 0.0]),
    lambda m: m.firwin2(64, [0.0, 1.0], [1.0, 1.0]),
    lambda m: m.firwin2(64, [0.0, 1.0], [1.0, 1.0], antisymmetric=True),
    lambda m: m.firwin2(65, [0.0, 1.0], [1.0, 1.0], antisymmetric=True),
    lambda m: m.firwin2(65, [0.0, 0.5, 0.4, 1.0], [1.0, 1.0, 0.0, 0.0]),
    lambda m: m.firwin2(65, [0.0, 0.5, 0.5, 0.5, 1.0], [1.0, 1.0, 0.0, 0.0, 0.0]),
    lambda m: m.firwin2(65, [0.0, 1.0], [1.0, 0.0], nfreqs=33),
    lambda m: m.firls(10, [0, 0.5, 0.6, 1.0], [1, 1, 0, 0]),
    lambda m: m.firls(11, [0, 0.5, 0.6], [1, 1, 0]),
    lambda m: m.firls(11, [0, 0.5, 0.6, 1.0], [1, 1, 0]),
    lambda m: m.remez(33, [0, 0.1, 0.2], [1, 0]),
    lambda m: m.remez(33, [0, 0.1, 0.2, 0.5], [1, 0, 1], sampling_rate=1.0),
    lambda m: m.remez(32, [0, 0.2, 0.3, 0.5], [0, 1], sampling_rate=1.0),
    lambda m: m.remez(2, [0, 0.2, 0.3, 0.5], [1, 0], sampling_rate=1.0),
    lambda m: m.minimum_phase([1.0, 2.0]),
    lambda m: m.minimum_phase([0.25, 0.5, 0.25], n_fft=2),
])
def test_errors_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jf)
    with pytest.raises(ValueError) as got:
        call(tf)
    assert str(got.value) == str(want.value)
