"""Parity of the port's ShortTimeFFT (nx_signal_tpu_torch/spectral/
short_time_fft.py) with the JAX package's, on the CPU, with the same numpy
inputs.

Tolerances: spectra and reconstructions within 1e-4 of the max, the JAX
package's gate (the JAX class computes in f64 where its window is f64, the
port in the signal's float32); the host bookkeeping (slice ranges, borders,
times, frequencies, dual windows, closest_STFT_dual_window) exactly or at
1e-12 (a kaiser window at 2e-6 of its max: the JAX package evaluates its
I0 in float32, the port in f64). The overlap-add is held bitwise against the port's own fold
(`spectral.framing._ola_fold`) of the same frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.spectral import short_time_fft as jsft
from nx_signal_tpu_torch.spectral import short_time_fft as tsft
from nx_signal_tpu_torch.spectral.framing import _ola_fold


def close_to_max(got, want, rel=1e-4):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def pair(win, hop, fs=1000.0, **kw):
    return jsft.ShortTimeFFT(win, hop, fs, **kw), tsft.ShortTimeFFT(win, hop, fs, **kw)


@pytest.mark.parametrize("fft_mode,scale_to", [("onesided", None), ("twosided", None),
                                               ("centered", "magnitude"),
                                               ("onesided2X", "psd"),
                                               ("onesided2X", "magnitude")])
@pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
def test_stft_and_istft_match_jax(fft_mode, scale_to, padding, rng):
    x = rng.normal(size=(2, 700)).astype(np.float32)
    j, t = pair(np.hanning(64), 16, fft_mode=fft_mode, scale_to=scale_to, mfft=80)
    want = j.stft(jnp.asarray(x), padding=padding)
    got = t.stft(torch.from_numpy(x), padding=padding)
    assert got.dtype == torch.complex64
    close_to_max(got, want)
    rec = t.istft(got, k1=700)
    close_to_max(rec.real if rec.is_complex() else rec, np.asarray(j.istft(want, k1=700)).real)
    np.testing.assert_allclose(rec.real.numpy() if rec.is_complex() else rec.numpy(), x,
                               rtol=0, atol=1e-4 * np.abs(x).max())


@pytest.mark.parametrize("phase_shift", [None, 0, 5, -21])
@pytest.mark.parametrize("fft_mode", ["onesided", "centered"])
def test_phase_shift_matches_jax(phase_shift, fft_mode, rng):
    x = rng.normal(size=500).astype(np.float32)
    j, t = pair(np.hanning(50), 10, fft_mode=fft_mode, phase_shift=phase_shift)
    want = j.stft(jnp.asarray(x))
    got = t.stft(torch.from_numpy(x))
    close_to_max(got, want)
    close_to_max(t.istft(got, k1=500).real, np.asarray(j.istft(want, k1=500)).real)


@pytest.mark.parametrize("detr", ["constant", "linear", "callable"])
def test_stft_detrend_matches_jax(detr, rng):
    x = (rng.normal(size=(3, 400)) + np.linspace(0, 5, 400)).astype(np.float32)
    j, t = pair(np.hanning(48), 12)
    dj = (lambda f: f - jnp.mean(f, axis=-1, keepdims=True)) if detr == "callable" else detr
    dt = (lambda f: f - f.mean(dim=-1, keepdim=True)) if detr == "callable" else detr
    close_to_max(t.stft_detrend(torch.from_numpy(x), dt), j.stft_detrend(jnp.asarray(x), dj))


@pytest.mark.parametrize("mfft", [64, 100, 1021, 2048])
def test_framed_dft_route_matches_jax(mfft, rng, monkeypatch):
    """fft_method='matmul' forces the framed_dft route (kernel B-fft's
    contract, its plain version on the CPU) where mfft <= 1024; past it
    the route is torch.fft."""
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    j, t = pair(np.hanning(64), 24, mfft=mfft, phase_shift=3)
    monkeypatch.setattr(t, "fft_method", "matmul")
    close_to_max(t.stft(torch.from_numpy(x)), j.stft(jnp.asarray(x)))
    close_to_max(t.stft(torch.from_numpy(x), padding="even"),
                 j.stft(jnp.asarray(x), padding="even"))


def test_istft_fold_is_the_ports_fold_bitwise(rng):
    """istft's overlap-add is _ola_fold of the dual-windowed frames,
    bitwise (kernel C's plain version here)."""
    x = rng.normal(size=(2, 900)).astype(np.float32)
    _, t = pair(np.hanning(128), 32)
    s = t.stft(torch.from_numpy(x))
    frames = t._synthesis_frames(s)
    # the frames themselves: the inverse rfft of the phase-corrected spectrum
    # times the dual window
    spec = s.transpose(-1, -2) * t._phase_factor(True, "cpu").to(s.dtype)
    direct = torch.fft.irfft(spec, n=t.mfft, dim=-1)[..., :t.m_num]
    assert torch.equal(frames, direct * torch.as_tensor(t.dual_win).to(torch.float32))
    full_len = (s.shape[-1] - 1) * t.hop + t.m_num
    grid0 = t.p_min * t.hop - t.m_num_mid
    want = _ola_fold(frames.contiguous(), t.hop, full_len)[..., -grid0:900 - grid0]
    got = t.istft(s, k1=900)
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_complex_input_axes_and_spectrogram_match_jax(rng):
    x = (rng.normal(size=(300, 2)) + 1j * rng.normal(size=(300, 2))).astype(np.complex64)
    j, t = pair(np.hanning(40), 10, fft_mode="twosided")
    want = j.stft(jnp.asarray(x), axis=0)
    got = t.stft(torch.from_numpy(x), axis=0)
    close_to_max(got, want)
    close_to_max(t.istft(got, k1=300, f_axis=0, t_axis=-1),
                 j.istft(want, k1=300, f_axis=0, t_axis=-1))
    y = rng.normal(size=300).astype(np.float32)
    j1, t1 = pair(np.hanning(40), 10)
    close_to_max(t1.spectrogram(torch.from_numpy(y)), j1.spectrogram(jnp.asarray(y)))
    close_to_max(t1.spectrogram(torch.from_numpy(y), torch.from_numpy(y[::-1].copy())),
                 j1.spectrogram(jnp.asarray(y), jnp.asarray(y[::-1].copy())))
    close_to_max(t1.stft(torch.from_numpy(y), 2, 9, k_offset=3),
                 j1.stft(jnp.asarray(y), 2, 9, k_offset=3))


@pytest.mark.parametrize("win,hop", [(np.hanning(64), 16), (np.r_[0.0, 0.0, np.ones(30), 0.0],
                                                            7), (np.kaiser(33, 6.0), 33)])
def test_bookkeeping_matches_jax(win, hop):
    j, t = pair(win, hop, fs=48000.0, fft_mode="centered")
    for name in ("p_min", "k_min", "lower_border_end", "f_pts", "delta_f", "delta_t",
                 "invertible", "fac_magnitude", "fac_psd", "m_num_mid"):
        assert getattr(t, name) == getattr(j, name), name
    for n in (40, 333, 1000):
        assert (t.p_max(n), t.k_max(n), t.p_num(n), t.upper_border_begin(n)) == (
            j.p_max(n), j.k_max(n), j.p_num(n), j.upper_border_begin(n))
        np.testing.assert_array_equal(t.t(n), j.t(n))
        assert t.extent(n, "ft", True) == j.extent(n, "ft", True)
        assert t.extent(n) == j.extent(n)
    np.testing.assert_array_equal(t.f, j.f)
    assert t.nearest_k_p(100) == j.nearest_k_p(100)
    assert t.nearest_k_p(101, left=False) == j.nearest_k_p(101, left=False)
    if j.invertible:
        np.testing.assert_array_equal(t.dual_win, j.dual_win)


def test_constructors_match_jax(rng):
    x = rng.normal(size=600).astype(np.float32)
    for make in (lambda m: m.ShortTimeFFT.from_window(("kaiser", 5.0), 8000.0, 100, 60,
                                                      scale_to="psd", mfft=128),
                 lambda m: m.ShortTimeFFT.from_window("hann", 8000.0, 64, 48,
                                                      symmetric_win=True),
                 lambda m: m.ShortTimeFFT.from_dual(np.hanning(64), 16, 100.0),
                 lambda m: m.ShortTimeFFT.from_win_equals_dual(np.hanning(64), 16, 100.0,
                                                               scale_to="unitary"),
                 lambda m: m.ShortTimeFFT.from_win_equals_dual(np.hanning(60), 20, 100.0,
                                                               scale_to="magnitude")):
        j, t = make(jsft), make(tsft)
        # the JAX kaiser evaluates I0 in float32, the port's in f64
        rel = 2e-6 if t.win.shape[0] == 100 else 1e-12
        for got, want in ((t.win, j.win), (t.dual_win, j.dual_win)):
            np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())
        assert t.scaling == j.scaling
        close_to_max(t.stft(torch.from_numpy(x)), j.stft(jnp.asarray(x)))


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("desired", [None, "gauss", "complex"])
def test_closest_dual_window_matches_jax(scaled, desired):
    win = np.hanning(48) + 0.05
    g = {None: None, "gauss": np.exp(-np.linspace(-2, 2, 48) ** 2),
         "complex": np.exp(1j * np.linspace(0, 1, 48))}[desired]
    dj, aj = jsft.closest_STFT_dual_window(win, 12, g, scaled=scaled)
    dt, at = tsft.closest_STFT_dual_window(win, 12, g, scaled=scaled)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-12)


def test_errors_match_jax():
    def cases(m, arr):
        return [lambda: m.ShortTimeFFT(np.ones((2, 2)), 4, 1.0),
                lambda: m.ShortTimeFFT(np.ones(8), 0, 1.0),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0, mfft=4),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0, fft_mode="half"),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0, fft_mode="onesided2X"),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0, phase_shift=9),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0).scale_to("db"),
                lambda: m.ShortTimeFFT(np.ones(8), 9, 1.0).dual_win,
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0).stft(arr(np.ones(64)),
                                                               padding="wrap"),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0).istft(arr(np.ones((3, 20)) + 0j)),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0).stft(arr(np.ones(64) + 0j)),
                lambda: m.closest_STFT_dual_window(np.r_[1.0, 0.0, 1.0, 0.0], 2),
                lambda: m.ShortTimeFFT(np.ones(8), 4, 1.0).p_range(64, 3, 2)]

    for want_case, got_case in zip(cases(jsft, jnp.asarray), cases(tsft, torch.from_numpy)):
        with pytest.raises(ValueError) as want:
            want_case()
        with pytest.raises(ValueError) as got:
            got_case()
        assert str(got.value).split("(S.shape")[0] == str(want.value).split("(S.shape")[0]
