"""Parity of the port's mixing (mix_down, demodulate_channel in
nx_signal_tpu_torch/ops/mixing.py) with the JAX package's
(nx_signal_tpu/ops/mixing.py), on the CPU, with the same numpy inputs
made from a seed.

Both packages build the local oscillator from the same float32 argument,
-2*pi*(fc/fs) * n - phase with a float32 sample index n, and take its
complex64 exponential. Tolerance: 1e-5 of the max of the JAX result, at
every length, the 2 880 000-sample case (60 s at 48 kHz) included. An f64
mixer differs from both: on a ones signal at fc/fs = 12345/48000 by
6.6e-3 at 48 000 samples, 0.41 at 2 880 000 and 2.0 at 28 800 000
(`test_mix_down_f32_phase_drift`, a pin in ROADMAP.md queue 3: the port
keeps the reference's f32 phase on purpose).
"""

import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import mixing as jm
from nx_signal_tpu_torch.ops import mixing as tm


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_to_max(got, want, rel=1e-5):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("length,fc,fs,phase", [
    (8, 0.25, 1.0, 0.0), (48000, 10000.0, 48000.0, 0.0), (4096, 1000.0, 16000.0, 0.7),
    (48000, 12345.0, 48000.0, -1.25)])
def test_mix_down_matches_jax(length, fc, fs, phase):
    x = np.random.default_rng(0).normal(size=(3, length)).astype(np.float32)
    got = tm.mix_down(T(x), fc, fs, phase=phase)
    assert got.dtype == torch.complex64
    close_to_max(got, jm.mix_down(x, fc, fs, phase=phase))


def test_mix_down_at_2880000_samples_matches_jax():
    """60 s at 48 kHz (BASELINE.json config 4's chain at 60 s): the f32
    argument is the same in both packages, so the drift from f64 is too."""
    n = 2_880_000
    x = np.ones(n, np.float32)
    got = tm.mix_down(T(x), 12345.0, 48000.0)
    close_to_max(got, jm.mix_down(x, 12345.0, 48000.0))


@pytest.mark.parametrize("n,drift", [(48_000, 6.6e-3), (2_880_000, 0.41), (28_800_000, 2.0)])
def test_mix_down_f32_phase_drift(n, drift):
    """The largest error of the port's oscillator against exp(-2i*pi*(fc/fs)
    n) in f64, at fc/fs = 12345/48000: the reference's f32 phase, kept
    (28 800 000 samples: 10 min at 48 kHz, in pieces of 2 880 000)."""
    lo = tm.mix_down(torch.ones(n), 12345.0, 48000.0).numpy()
    err = 0.0
    for start in range(0, n, 2_880_000):
        idx = np.arange(start, min(start + 2_880_000, n))
        ref = np.exp(-2j * np.pi * (12345.0 / 48000.0) * idx)
        err = max(err, float(np.abs(lo[idx] - ref).max()))
    assert err == pytest.approx(drift, rel=0.05)


def test_mix_down_dtypes():
    x64 = np.random.default_rng(1).normal(size=100)
    got = tm.mix_down(T(x64), 5.0, 100.0)
    assert got.dtype == torch.complex128
    close_to_max(got, jm.mix_down(x64, 5.0, 100.0))
    xc = (x64 + 1j * x64[::-1]).astype(np.complex64)
    close_to_max(tm.mix_down(T(xc), 5.0, 100.0), jm.mix_down(xc, 5.0, 100.0))


@pytest.mark.parametrize("shape,fc,bw,dec,taps", [
    ((4 * 48000,), 12000.0, 4000.0, 6, 129), ((3, 24000), 1000.0, 200.0, 4, 129),
    ((2, 48000), 12000.0, 4000.0, 6, 61)])
def test_demodulate_channel_matches_jax(shape, fc, bw, dec, taps):
    t = np.arange(shape[-1]) / 48000.0
    x = (np.cos(2 * np.pi * (fc + 300.0) * t) + np.cos(2 * np.pi * 4000.0 * t)
         + 0.1 * np.random.default_rng(2).normal(size=shape)).astype(np.float32)
    got = tm.demodulate_channel(T(x), fc, 48000.0, bandwidth=bw, decimation=dec,
                                num_taps=taps)
    want = jm.demodulate_channel(x, fc, 48000.0, bandwidth=bw, decimation=dec, num_taps=taps)
    assert got.dtype == torch.complex64
    close_to_max(got, want)


def test_demodulate_channel_rejects_decimation_below_one():
    for mod, arg in ((jm, np.ones(64, np.float32)), (tm, torch.ones(64))):
        with pytest.raises(ValueError, match="decimation must be >= 1, got: 0"):
            mod.demodulate_channel(arg, 1.0, 8.0, bandwidth=1.0, decimation=0)
