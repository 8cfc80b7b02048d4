"""Parity of the PyTorch port's stft / istft / fft_frequencies with the JAX
package, on the CPU (the kernels' plain versions).

Tolerances:
* stft spectra: 1e-4 x max|z|, the JAX package's gate — f32 contractions
  (or f32 FFTs) summed in a different order on each side.
* istft: 1e-4 absolute against the JAX istft on the same spectrum (unit-
  variance signals, so 1e-4 is the same gate relative to the signal), on
  the samples whose window envelope sum(w^2) is at least 1e-3 of its peak.
  At the tapered ends the normalization divides by that envelope, which
  multiplies the inverse FFT's f32 rounding by up to 1/w there.
* frame times and bin frequencies: rtol 1e-6 — f32 linspace in two
  libraries, whose formulas may round the last ulp differently.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu.spectral.framing import overlap_and_add

# the JAX package's spectral/__init__ re-exports the function under the
# module's name, so the module is fetched by its path
js = importlib.import_module("nx_signal_tpu.spectral.stft")
ts = importlib.import_module("nx_signal_tpu_torch.spectral.stft")


def assert_close_to_max(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def hann_np(n):
    return np.array(jw.hann(n))


@pytest.mark.parametrize("padding", ["valid", "same", "reflect"])
@pytest.mark.parametrize("scaling", [None, "spectrum", "psd"])
@pytest.mark.parametrize("onesided", [True, False])
def test_stft_matches_jax(padding, scaling, onesided, rng):
    x = rng.normal(size=(2, 2000)).astype(np.float32)
    window = hann_np(256)
    kw = dict(sampling_rate=16000.0, overlap_length=192, window_padding=padding,
              scaling=scaling, onesided=onesided)
    want = js.stft(jnp.asarray(x), window, **kw)
    got = ts.stft(torch.from_numpy(x), torch.from_numpy(window), **kw)
    assert got.z.dtype == torch.complex64
    assert_close_to_max(got.z, np.asarray(want.z).astype(np.complex64))
    np.testing.assert_allclose(got.times, np.asarray(want.times), rtol=1e-6)
    np.testing.assert_allclose(got.frequencies, np.asarray(want.frequencies), rtol=1e-6)


@pytest.mark.parametrize("frame,overlap,fft_length,method,complex_input", [
    (400, 240, "power_of_two", "auto", False),   # hop 160 does not divide the frame
    (128, 64, 2048, "auto", False),              # fft_length > 1024: torch.fft
    (128, 96, 128, "auto", True),                # complex input: torch.fft
    (256, 128, 256, "fft", False),
    (256, 128, 256, "matmul", False),
    # fft_lengths with no prime factor above 7 (B-fft's mixed-radix kernel on
    # the card): Whisper's 400 / 160, odd 441, 600 > frame, 10 ms at 48 kHz
    (400, 240, 400, "auto", False),
    (441, 294, 441, "auto", False),
    (512, 384, 600, "auto", False),
    (480, 240, 480, "auto", False),
])
def test_stft_paths_match_jax(frame, overlap, fft_length, method, complex_input, rng):
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    if complex_input:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    window = hann_np(frame)
    kw = dict(sampling_rate=1000.0, overlap_length=overlap, fft_length=fft_length,
              method=method)
    want = js.stft(jnp.asarray(x), window, **kw)
    got = ts.stft(torch.from_numpy(x), window, **kw)
    assert_close_to_max(got.z, np.asarray(want.z).astype(np.complex64))


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("scaling", [None, "psd"])
@pytest.mark.parametrize("method", ["auto", "fft"])
def test_istft_matches_jax(onesided, scaling, method, rng):
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    window = hann_np(256)
    kw = dict(overlap_length=192, scaling=scaling, sampling_rate=8000.0,
              onesided=onesided)
    z = np.asarray(js.stft(jnp.asarray(x), window, **kw).z).astype(np.complex64)
    want = np.asarray(js.istft(jnp.asarray(z), window, method=method, **kw))
    got = ts.istft(torch.from_numpy(z), torch.from_numpy(window), method=method, **kw)
    assert got.dtype == (torch.float32 if onesided else torch.complex64)
    assert got.shape == want.shape
    envelope = np.asarray(overlap_and_add(
        np.broadcast_to(window.astype(np.float64) ** 2, (z.shape[-2], 256)),
        overlap_length=192))
    inner = envelope >= 1e-3 * envelope.max()
    np.testing.assert_allclose(got.numpy()[..., inner],
                               want.astype(got.numpy().dtype)[..., inner], rtol=0, atol=1e-4)


@pytest.mark.parametrize("frame,overlap", [(512, 384), (400, 240), (256, 128)])
def test_round_trip_interior(frame, overlap, rng):
    # perfect reconstruction in the overlapping interior, to f32 accuracy
    x = torch.from_numpy(rng.normal(size=(3, 8192)).astype(np.float32))
    window = torch.from_numpy(hann_np(frame))
    n_fft = frame  # istft's window spans the transform
    z = ts.stft(x, window, fft_length=n_fft, overlap_length=overlap, onesided=True).z
    y = ts.istft(z, window, fft_length=n_fft, overlap_length=overlap, onesided=True)
    n = y.shape[-1]
    err = (y[:, frame:n - frame] - x[:, frame:n - frame]).abs().max()
    assert float(err) <= 1e-5 * float(x.abs().max())


@pytest.mark.parametrize("sampling_rate,n", [(10.0, 5), (16000.0, 512), (48000, 1000),
                                             (7.5, 1)])
@pytest.mark.parametrize("endpoint", [False, True])
def test_fft_frequencies(sampling_rate, n, endpoint):
    want = js.fft_frequencies(sampling_rate, fft_length=n, endpoint=endpoint)
    got = ts.fft_frequencies(sampling_rate, fft_length=n, endpoint=endpoint)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_stft_istft_errors():
    x, w = torch.zeros(1000), torch.from_numpy(hann_np(64))
    with pytest.raises(ValueError, match="overlap_length"):
        ts.stft(x, w, overlap_length=64)
    with pytest.raises(ValueError, match="method"):
        ts.stft(x, w, method="winograd")
    with pytest.raises(ValueError, match="scaling"):
        ts.stft(x, w, scaling="energy")
    with pytest.raises(ValueError, match="sampling_rate is mandatory"):
        ts._apply_scaling(x, w, "psd", None, inverse=False)
    with pytest.raises(ValueError, match="requires real input"):
        ts.stft(x.to(torch.complex64), w, method="matmul")
    with pytest.raises(ValueError, match="fft_length >= frame_length"):
        ts.stft(x, w, fft_length=32, method="matmul")
    with pytest.raises(ValueError, match="less than the window size"):
        ts.istft(torch.zeros(3, 33, dtype=torch.complex64), w, onesided=True,
                 overlap_length=64)


COLA_CASES = [  # window, nperseg, noverlap
    ("hann", 8, 4), ("hann", 8, 3), ("hann", 256, 192), ("hamming", 64, 32),
    ("blackman", 96, 64), ("blackman", 96, 72), ("hann", 10, 3), ("hann", 8, 0),
    (("general_cosine", [0.5, 0.5]), 16, 8),
]


@pytest.mark.parametrize("window,nperseg,noverlap", COLA_CASES)
def test_check_cola_and_nola_match_jax(window, nperseg, noverlap):
    """Named windows resolve to the periodic f64 form, as the JAX package
    and scipy resolve them."""
    for name in ("check_cola", "check_nola"):
        assert getattr(ts, name)(window, nperseg, noverlap) is \
            getattr(js, name)(window, nperseg, noverlap), name


def test_check_cola_named_window_is_periodic_f64():
    # the f32 periodic hann deviates ~6e-8 from COLA, the symmetric one far
    # more: only the periodic f64 form passes the 1e-10 default tolerance
    assert ts.check_cola("hann", 256, 128)
    assert not ts.check_cola(hann_np(256).astype(np.float32), 256, 128)
    assert not ts.check_cola(np.asarray(jw.hann(256, periodic=False), np.float64), 256, 128)
    assert ts.check_cola(torch.from_numpy(hann_np(256)).double(), 256, 128, tol=1e-6)
    assert ts.check_COLA is ts.check_cola and ts.check_NOLA is ts.check_nola


@pytest.mark.parametrize("window", [np.ones(16), np.asarray(jw.hamming(16), np.float64)])
@pytest.mark.parametrize("noverlap", [0, 5, 8, 15])
def test_check_cola_and_nola_arrays_match_jax(window, noverlap):
    for name in ("check_cola", "check_nola"):
        assert getattr(ts, name)(window, 16, noverlap) is \
            getattr(js, name)(window, 16, noverlap), name


def test_check_cola_nola_errors():
    for fn in (ts.check_cola, ts.check_nola):
        with pytest.raises(ValueError, match="noverlap must be less than nperseg"):
            fn("hann", 8, 8)
        with pytest.raises(ValueError, match="length of nperseg"):
            fn(np.ones(7), 8, 4)
        with pytest.raises(ValueError, match="1-D"):
            fn(np.ones((2, 8)), 8, 4)
    with pytest.raises(ValueError, match="tol must be positive"):
        ts.check_nola("hann", 8, 4, tol=0.0)
