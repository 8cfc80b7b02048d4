"""Parity of the port's polyphase resampling and filterbank
(nx_signal_tpu_torch/ops/resample.py) with the JAX package's
(nx_signal_tpu/ops/resample.py), on the CPU, with the same numpy inputs
made from a seed (and the same numpy f64 taps and prototypes wherever a
case passes `taps=` or `h`).

Tolerances: float32 signals within 1e-5 of the max of the JAX package's
result (XLA and oneDNN sum the banded contraction in other orders);
float64 signals within 1e-12 of the max (f64 sums in both); the Fourier
`resample` (f64 FFTs in both) 1e-12 of the max (1e-5 with a Kaiser
window: the pinned f64 Kaiser difference, ROADMAP.md queue 3); `decimate` 'iir' and
'sos' at the port's IIR gates (tests/test_torch_iir.py: 1e-9 absolute
and 1e-7 relative on f64); `pfb_footprint_bytes` exactly. Where the JAX
function cannot run a case (its `resample` with a callable window raises
NameError: its module never imports numpy), scipy f64 is the oracle at
1e-12.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import resample as jr
from nx_signal_tpu_torch.kernels import dft as td
from nx_signal_tpu_torch.ops import resample as tr


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_to_max(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def signal(seed, shape, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


GATE = {np.float32: 1e-5, np.float64: 1e-12}


# ------------------------------------------------------------------ upfirdn

# tests/test_resample.py:14-17
UP_DOWN = [(1, 1), (1, 3), (3, 1), (2, 3), (3, 2), (7, 5), (160, 147), (1, 13)]
N_K = [(50, 11), (128, 31), (13, 40)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,k", N_K)
@pytest.mark.parametrize("up,down", UP_DOWN)
def test_upfirdn_matches_jax(up, down, n, k, dtype):
    x, h = signal(1, n, dtype), signal(2, k, dtype)
    got = tr.upfirdn(T(h), T(x), up, down)
    want = np.asarray(jr.upfirdn(h, x, up, down))
    assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    close_to_max(got, want, GATE[dtype])
    close_to_max(got, sps.upfirdn(h.astype(np.float64), x.astype(np.float64), up, down),
                 10 * GATE[dtype])


# tests/test_resample.py:50-57: multi-tile with a partial last frame, the
# huge-down fallback to R = up, up > 128, n_count < up
TILE_CASES = [(1, 3, 10000, 61), (2, 3, 9999, 63), (1, 1, 3000, 31), (7, 5, 4000, 35),
              (1, 1000, 5000, 21), (160, 1, 500, 320), (2, 3, 5, 9)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("up,down,n,k", TILE_CASES)
def test_upfirdn_tile_geometry_matches_jax(up, down, n, k, dtype):
    x, h = signal(3, n, dtype), signal(4, k, dtype)
    got = tr.upfirdn(T(h), T(x), up, down)
    close_to_max(got, np.asarray(jr.upfirdn(h, x, up, down)), GATE[dtype])


def test_upfirdn_tile_falls_back_to_up(monkeypatch):
    """At down=1000 the banded weight of a 128-output tile would pass 2^22
    elements, so the tile is R = up = 1 (one output per frame row): the
    contraction's weights are one column."""
    seen = []
    real = tr.blocked_frame_matmul

    def spy(x, w, **kw):
        seen.append(tuple(w.shape))
        return real(x, w, **kw)

    monkeypatch.setattr(tr, "blocked_frame_matmul", spy)
    tr.upfirdn(T(signal(5, 21)), T(signal(6, 5000)), 1, 1000)
    tr.upfirdn(T(signal(5, 61)), T(signal(6, 5000)), 1, 3)
    assert seen[0][1] == 1
    assert seen[1] == (61 + 127 * 3, 128)  # the 128-output tile, C = 2 blocks of 384


@pytest.mark.parametrize("taps_complex", [False, True])
def test_upfirdn_complex_input(taps_complex):
    """Complex signals take 'materialize' (tests/test_resample.py:38-41),
    complex64 in, complex64 out."""
    x = (signal(7, (2, 40)) + 1j * signal(8, (2, 40))).astype(np.complex64)
    h = signal(9, 7, np.float32)
    if taps_complex:
        h = (h + 1j * signal(10, 7, np.float32)).astype(np.complex64)
    got = tr.upfirdn(T(h), T(x), 2, 5)
    assert got.dtype == torch.complex64
    close_to_max(got, np.asarray(jr.upfirdn(h, x, 2, 5)), 1e-5)


def test_blocked_frame_matmul_complex_signal_real_weights():
    """A complex signal against real weights on 'materialize' contracts in
    the promoted dtype (before, torch.matmul refused complex64 @ float32)."""
    x = (signal(11, 300) + 1j * signal(12, 300)).astype(np.complex64)
    w = signal(13, (20, 6), np.float32)
    got = td.blocked_frame_matmul(T(x), T(w), window_length=20, stride=7, num_frames=30,
                                  strategy="materialize")
    frames = np.lib.stride_tricks.sliding_window_view(x.astype(np.complex128), 20)[::7][:30]
    close_to_max(got, frames @ w.astype(np.float64), 1e-6)


def test_upfirdn_batched():
    x, h = signal(14, (3, 64), np.float32), signal(15, 9, np.float32)
    got = tr.upfirdn(T(h), T(x), 2, 3)
    close_to_max(got, np.asarray(jr.upfirdn(h, x, 2, 3)), 1e-5)
    x3 = signal(16, (2, 3, 100), np.float32)
    close_to_max(tr.upfirdn(T(h), T(x3), 3, 2), np.asarray(jr.upfirdn(h, x3, 3, 2)), 1e-5)


def test_upfirdn_integer_input_is_float32():
    got = tr.upfirdn(torch.tensor([1, 1]), torch.arange(5), 2, 1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jr.upfirdn(
        np.array([1, 1]), np.arange(5), 2, 1)))


@pytest.mark.parametrize("call,pattern", [
    (lambda m: m.upfirdn(np.ones((2, 2)), np.ones(4)), "must be 1-D"),
    (lambda m: m.upfirdn(np.ones(3), np.ones(4), up=0), ">= 1"),
    (lambda m: m.resample_poly(np.ones(8), 0, 2), ">= 1"),
    (lambda m: m.resample_poly(np.ones(8), 1, 2, taps=np.ones(4)), "odd length"),
])
def test_validation_messages_match_jax(call, pattern):
    with pytest.raises(ValueError, match=pattern) as jax_err:
        call(jr)
    with pytest.raises(ValueError, match=pattern) as port_err:
        call(_CpuResample)
    assert str(port_err.value) == str(jax_err.value)


class _CpuResample:
    """The port's functions with numpy arguments as CPU tensors."""

    @staticmethod
    def upfirdn(h, x, *args, **kw):
        return tr.upfirdn(T(h), T(x), *args, **kw)

    @staticmethod
    def resample_poly(x, *args, **kw):
        return tr.resample_poly(T(x), *args, **kw)


# ------------------------------------------------------------ resample_poly

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (2, 3), (160, 147), (48, 16)])
def test_resample_poly_matches_jax(up, down, dtype):
    x = signal(17, (2, 1000), dtype)
    got = tr.resample_poly(T(x), up, down)
    close_to_max(got, np.asarray(jr.resample_poly(x, up, down)), 1e-5)


@pytest.mark.parametrize("window", [("kaiser", 5.0), "hamming", ("kaiser", 8.0)])
def test_resample_poly_window_matches_jax(window):
    x = signal(18, (2, 900), np.float32)
    close_to_max(tr.resample_poly(T(x), 2, 3, window=window),
                 np.asarray(jr.resample_poly(x, 2, 3, window=window)), 1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resample_poly_custom_prototype(dtype):
    x = signal(19, (3, 600), dtype)
    taps = sps.firwin(45, 0.3)  # numpy f64, to both packages
    got = tr.resample_poly(T(x), 3, 2, taps=taps)
    close_to_max(got, np.asarray(jr.resample_poly(x, 3, 2, taps=taps)), GATE[dtype])
    close_to_max(got, sps.resample_poly(x.astype(np.float64), 3, 2, window=taps, axis=-1)
                 [..., :got.shape[-1]], 10 * GATE[dtype])


def test_resample_poly_identity_ratio():
    x = T(signal(20, (2, 64), np.float32))
    assert tr.resample_poly(x, 7, 7) is x


def test_resample_poly_48k_to_16k_tone():
    """tests/test_resample.py:84-97: a 1 kHz tone at 48 kHz survives the
    decimation to 16 kHz with its frequency and amplitude, as in the JAX
    package."""
    fs = 48000
    x = np.sin(2 * np.pi * 1000 * np.arange(fs) / fs).astype(np.float32)
    y = tr.resample_poly(T(x), 1, 3).numpy()
    assert y.shape == (fs // 3,)
    close_to_max(y, np.asarray(jr.resample_poly(x, 1, 3)), 1e-5)
    spec = np.abs(np.fft.rfft(y[1000:9000] * np.hanning(8000)))
    assert abs(np.argmax(spec) * 16000 / 8000 - 1000) < 5
    assert abs(np.abs(y[2000:14000]).max() - 1.0) < 0.01


# ----------------------------------------------------------------- resample

@pytest.mark.parametrize("n_in,num", [(100, 37), (100, 50), (100, 64), (100, 99), (100, 101),
                                      (100, 150), (99, 44), (99, 150), (64, 32), (64, 200)])
def test_resample_fourier_matches_jax(n_in, num):
    x = signal(21, (3, n_in))
    got = tr.resample(T(x), num)
    close_to_max(got, np.asarray(jr.resample(x, num)), 1e-12)
    close_to_max(got, sps.resample(x, num, axis=-1), 1e-12)


def test_resample_fourier_complex_and_float32():
    xc = signal(22, 100) + 1j * signal(23, 100)
    close_to_max(tr.resample(T(xc), 63), np.asarray(jr.resample(xc, 63)), 1e-12)
    x32 = signal(24, (2, 90), np.float32)
    got = tr.resample(T(x32), 40)
    assert got.dtype == torch.float32
    close_to_max(got, np.asarray(jr.resample(x32, 40)), 1e-5)


def test_resample_fourier_axis():
    x = signal(25, (4, 80, 3))
    close_to_max(tr.resample(T(x), 40, axis=1), np.asarray(jr.resample(x, 40, axis=1)), 1e-12)


@pytest.mark.parametrize("num", [50, 130])
def test_resample_fourier_window_forms(num):
    """A spec (periodic, ifftshifted), a raw array in fftfreq order, and a
    callable on fftfreq: the first two against the JAX package, all three
    against scipy."""
    x = signal(26, (2, 100))
    for window, gate in (("hamming", 1e-12), (("kaiser", 6.0), 1e-5)):
        # the JAX package's f64 Kaiser is off scipy's by ~4e-7 (ROADMAP.md
        # queue 3, "Kaiser in f64"): held to it at the f32 gate
        got = tr.resample(T(x), num, window=window)
        close_to_max(got, np.asarray(jr.resample(x, num, window=window)), gate)
        close_to_max(got, sps.resample(x, num, axis=-1, window=window), 1e-12)
    w = (np.abs(np.fft.fftfreq(100)) < 0.3).astype(np.float64)
    got = tr.resample(T(x), num, window=w)
    close_to_max(got, np.asarray(jr.resample(x, num, window=w)), 1e-12)
    fn = lambda f: np.exp(-(f / 0.2) ** 2)  # noqa: E731
    close_to_max(tr.resample(T(x), num, window=fn), sps.resample(x, num, axis=-1, window=fn),
                 1e-12)


def test_resample_fourier_validation():
    for call in (lambda m, a: m.resample(a(np.zeros(10)), 0),
                 lambda m, a: m.resample(a(np.zeros(10)), 5, window=np.ones(7))):
        with pytest.raises(ValueError) as jax_err:
            call(jr, np.asarray)
        with pytest.raises(ValueError) as port_err:
            call(tr, T)
        assert str(port_err.value) == str(jax_err.value)


# ----------------------------------------------------------------- decimate

@pytest.mark.parametrize("zero_phase", [True, False])
@pytest.mark.parametrize("ftype,q", [("iir", 2), ("iir", 4), ("sos", 3), ("sos", 4),
                                     ("fir", 3), ("fir", 5)])
def test_decimate_matches_jax(ftype, q, zero_phase):
    x = signal(27, (2, 500))
    got = tr.decimate(T(x), q, ftype=ftype, zero_phase=zero_phase)
    want = np.asarray(jr.decimate(x, q, ftype=ftype, zero_phase=zero_phase))
    assert got.shape == want.shape
    if ftype == "fir":  # firwin designs in f32 in both packages
        close_to_max(got, want, 1e-5)
        np.testing.assert_allclose(got.numpy(), sps.decimate(
            x, q, ftype="fir", zero_phase=zero_phase), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=1e-7)
        np.testing.assert_allclose(got.numpy(), sps.decimate(x, q, zero_phase=zero_phase),
                                   atol=1e-8, rtol=1e-6)


def test_decimate_axis_and_float32():
    x = signal(28, (300, 3))
    np.testing.assert_allclose(tr.decimate(T(x), 3, axis=0).numpy(),
                               np.asarray(jr.decimate(x, 3, axis=0)), atol=1e-9, rtol=1e-7)
    x32 = signal(29, (2, 480), np.float32)
    for ftype in ("iir", "sos", "fir"):
        got = tr.decimate(T(x32), 3, ftype=ftype)
        assert got.dtype == torch.float32
        close_to_max(got, np.asarray(jr.decimate(x32.astype(np.float64), 3, ftype=ftype)),
                     1e-4)


def test_decimate_validation():
    with pytest.raises(ValueError, match="positive"):
        tr.decimate(torch.zeros(10), 0)
    with pytest.raises(ValueError, match="ftype must be 'iir', 'fir', or 'sos', got 'nope'"):
        tr.decimate(torch.zeros(100), 2, ftype="nope")


# ---------------------------------------------------------------- pfb_analyze

# tests/test_resample.py:153-158
PFB_CASES = [(64, 8, (2,), 50000), (8, 4, (), 4096), (1024, 8, (1,), 100000),
             (16, 6, (2, 3), 5000)]


@pytest.mark.parametrize("strategy", ["matmul", "factored", "einsum"])
@pytest.mark.parametrize("m,tpc,shape,length", PFB_CASES, ids=str)
def test_pfb_analyze_matches_jax(strategy, m, tpc, shape, length):
    x = signal(30, (*shape, length), np.float32)
    got = tr.pfb_analyze(T(x), m, taps_per_channel=tpc, strategy=strategy)
    want = np.asarray(jr.pfb_analyze(x, m, taps_per_channel=tpc, strategy=strategy))
    assert got.dtype == torch.complex64
    close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("m", [16, 64, 256])
@pytest.mark.parametrize("sum_mode", ["conv", "shifts"])
def test_pfb_factored_sum_matches_jax(m, sum_mode):
    """The port's polyphase sum (a depthwise conv1d at every band count)
    against both of the JAX package's lowerings of it (a depthwise conv
    below 128 bands, shifted multiply-adds from there on)."""
    x = T(signal(31, (2, 40 * m), np.float32))
    proto = tr.firwin(m * 8, [1.0 / m], window=("kaiser", 5.0), device="cpu")
    got = tr._pfb_factored(x, proto, m, 8)
    want = np.asarray(jr._pfb_factored(jnp.asarray(x.numpy()), jnp.asarray(proto.numpy()), m, 8,
                                       "highest", sum_mode=sum_mode))
    close_to_max(got, want, 1e-5)


def test_pfb_analyze_auto_and_shift():
    x = signal(32, (2, 6000), np.float32)
    for m in (16, 64):
        for shift in (False, True):
            got = tr.pfb_analyze(T(x), m, taps_per_channel=4, shift=shift)
            close_to_max(got, np.asarray(jr.pfb_analyze(x, m, taps_per_channel=4, shift=shift)),
                         1e-5)
    xc = (signal(33, 3000) + 1j * signal(34, 3000)).astype(np.complex64)
    got = tr.pfb_analyze(T(xc), 8, taps_per_channel=4, shift=True)
    np.testing.assert_array_equal(got.numpy(), tr.pfb_analyze(
        T(xc), 8, taps_per_channel=4, strategy="einsum", shift=True).numpy())
    close_to_max(got, np.asarray(jr.pfb_analyze(xc, 8, taps_per_channel=4, shift=True)), 1e-5)


def test_pfb_analyze_custom_prototype_and_f64():
    x = signal(35, 1024, np.float32)
    taps = sps.firwin(16 * 6, 1 / 16)  # numpy f64: the einsum path keeps f64
    got = tr.pfb_analyze(T(x), 16, taps=taps)
    assert got.dtype == torch.complex128
    close_to_max(got, np.asarray(jr.pfb_analyze(x, 16, taps=taps)), 1e-12)
    x64 = signal(36, 2048)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # 'auto' must not warn
        got = tr.pfb_analyze(T(x64), 16, taps_per_channel=4)
    assert got.dtype == torch.complex128
    # the default prototype is a float32 firwin in both packages, its
    # Kaiser window rounded to f32 from different f64 values: the f32 gate
    close_to_max(got, np.asarray(jr.pfb_analyze(x64, 16, taps_per_channel=4)), 1e-5)


@pytest.mark.parametrize("strategy", ["matmul", "factored"])
def test_pfb_analyze_f64_explicit_strategy_warns(strategy):
    x64 = T(signal(37, 2048))
    with pytest.warns(UserWarning, match="computes in float32"):
        got = tr.pfb_analyze(x64, 64 if strategy == "factored" else 16, taps_per_channel=4,
                             strategy=strategy)
    assert got.dtype == torch.complex64


@pytest.mark.parametrize("call,pattern", [
    (lambda m, a: m.pfb_analyze(a(np.ones(256)), 16, taps=np.ones(100)), "multiple of"),
    (lambda m, a: m.pfb_analyze(a(np.ones(4096, np.float32)), 8, strategy="bogus"),
     "strategy"),
    (lambda m, a: m.pfb_analyze(a(np.ones(100, np.float32)), 64, taps_per_channel=8),
     "shorter"),
    (lambda m, a: m.pfb_analyze(a(np.ones(300, np.complex64)), 8, taps_per_channel=4,
                                strategy="matmul"), "real input"),
])
def test_pfb_analyze_errors_match_jax(call, pattern):
    with pytest.raises(ValueError, match=pattern) as jax_err:
        call(jr, jnp.asarray)
    with pytest.raises(ValueError, match=pattern) as port_err:
        call(tr, T)
    assert str(port_err.value) == str(jax_err.value).replace("MXU ", "")


@pytest.mark.parametrize("strategy", ["einsum", "matmul", "factored"])
@pytest.mark.parametrize("batch,length,m,tpc", [(8, 4_194_304, 1024, 8), (8, 4_194_304, 64, 8),
                                                (1, 100_000_000, 1024, 8), (3, 5000, 16, 6)])
def test_pfb_footprint_bytes_matches_jax(strategy, batch, length, m, tpc):
    assert tr.pfb_footprint_bytes(strategy, batch, length, m, tpc) == \
        jr.pfb_footprint_bytes(strategy, batch, length, m, tpc)


def test_pfb_footprint_bytes_rejects_auto():
    with pytest.raises(ValueError, match="strategy must be 'matmul', 'factored' or 'einsum'"):
        tr.pfb_footprint_bytes("auto", 1, 1000, 8, 4)
