"""Parity of the port's filters (nx_signal_tpu_torch/ops/filters.py and
ops/ltisys.py:findfreqs) with the JAX package's, on the CPU, with the same
numpy inputs.

Tolerances, the JAX package's own (tests/test_filters.py,
tests/test_savgol_lomb_conv2d.py): median, order_filter, medfilt,
medfilt2d, max_len_seq and gammatone exactly (a selection, integer or the
same f64 numpy); wiener 1e-8 on f64 input (f64 sums in both) and 1e-6 on
float32 input (cast back to f32); savgol_coeffs 1e-10; savgol_filter 1e-8
absolute and 1e-6 relative on f64 input; the f64 analysis functions
(freqz, sosfreqz, freqz_sos, freqz_zpk, freqs, freqs_zpk, group_delay)
1e-10; firwin_2d and detrend of float32 input 1e-6 of the max (float32
arithmetic summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import filters as jf
from nx_signal_tpu.ops import ltisys as jl
from nx_signal_tpu_torch.ops import filters as tf
from nx_signal_tpu_torch.ops import ltisys as tl


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape,kernel", [((40,), (3,)), ((40,), (4,)), ((33,), (6,)),
                                          ((12, 9), (3, 2)), ((10, 11), (4, 4)),
                                          ((6, 5, 4), (2, 3, 2))])
def test_median_matches_jax(shape, kernel, rng):
    """Even window counts included: the mean of the two middle values."""
    t = rng.normal(size=shape).astype(np.float32)
    want = jf.median(jnp.asarray(t), kernel_shape=kernel)
    got = tf.median(T(t), kernel_shape=kernel)
    assert got.dtype == torch.float32
    close(got, want, 0.0)


@pytest.mark.parametrize("values,kernel", [([1.0, np.nan, 3.0, 4.0, 5.0], (3,)),
                                           ([1.0, 2.0, np.nan, 4.0, 5.0, 6.0], (4,)),
                                           ([np.inf, 1.0, -np.inf, 2.0], (2,))])
def test_median_propagates_nan_as_jax(values, kernel):
    """A window that holds a NaN gives NaN (torch.sort puts NaN last, so the
    middle values alone would hide it); [1, nan, 3, 4, 5] over 3 is
    [nan nan 4 4 4], as the JAX package gives it."""
    t = np.asarray(values, np.float32)
    want = np.asarray(jf.median(jnp.asarray(t), kernel_shape=kernel))
    got = tf.median(T(t), kernel_shape=kernel)
    np.testing.assert_array_equal(got.numpy(), want)
    if kernel == (3,):
        np.testing.assert_array_equal(got.numpy(), [np.nan, np.nan, 4.0, 4.0, 4.0])


def test_median_even_count_is_the_mean_of_the_middle_pair():
    got = tf.median(torch.tensor([1.0, 4.0, 2.0, 8.0]), kernel_shape=(4,))
    assert got.tolist() == [3.0, 3.0, 3.0, 3.0]   # torch.median would give 2.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jf.median(jnp.asarray([1.0, 4.0, 2.0, 8.0]), kernel_shape=(4,))))
    with pytest.raises(ValueError, match="same rank"):
        tf.median(torch.zeros(4, 4), kernel_shape=(2,))


@pytest.mark.parametrize("shape,ks,noise", [((64,), 5, None), ((20, 18), (3, 5), None),
                                            ((50,), 3, 0.3), ((9, 8, 7), 3, None)])
def test_wiener_matches_jax(shape, ks, noise, rng):
    t = rng.normal(size=shape)
    close(tf.wiener(T(t), kernel_size=ks, noise=noise),
          jf.wiener(jnp.asarray(t), kernel_size=ks, noise=noise), 1e-8)
    t32 = t.astype(np.float32)
    got = tf.wiener(T(t32), kernel_size=ks, noise=noise)
    assert got.dtype == torch.float32
    close(got, jf.wiener(jnp.asarray(t32), kernel_size=ks, noise=noise), 1e-6)
    with pytest.raises(ValueError, match="kernel_size"):
        tf.wiener(T(t), kernel_size=(3,) * (len(shape) + 1))


@pytest.mark.parametrize("hsize,window,kw", [
    ((5, 7), ("hamming", "hann"), dict(fc=0.4)),
    ((6, 6), ("blackman", ("kaiser", 5.0)), dict(fc=[0.2, 0.5], pass_zero="bandpass")),
    ((7, 5), "hamming", dict(fc=0.3, circular=True)),
    ((9, 9), ("tukey", 0.3), dict(fc=0.5, circular=True, sampling_rate=4.0))])
def test_firwin_2d_matches_jax(hsize, window, kw):
    want = np.asarray(jf.firwin_2d(hsize, window, **kw))
    close(tf.firwin_2d(hsize, window, device="cpu", **kw), want, 1e-6 * np.abs(want).max())


def test_firwin_2d_errors_match_jax():
    for args, kw in [(((3, 3, 3), "hann"), dict(fc=0.5)), (((3, 3), "hann"), {}),
                     (((3, 3), "hann"), dict(fc=0.5, circular=True, pass_zero="bad")),
                     (((3, 3), "hann"), dict(circular=True))]:
        with pytest.raises(ValueError) as want:
            jf.firwin_2d(*args, **kw)
        with pytest.raises(ValueError) as got:
            tf.firwin_2d(*args, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("whole", [False, True])
def test_freqz_family_matches_jax(whole, rng):
    b, a = rng.normal(size=9), np.array([1.0, -0.4, 0.2])
    sos = np.array([[0.2, 0.3, 0.1, 1.0, -0.5, 0.2], [1.0, -1.0, 0.5, 1.0, 0.1, 0.3]])
    kw = dict(n_freqs=64, sampling_rate=1000.0, whole=whole)
    for got, want in [(tf.freqz(T(b), T(a), **kw), jf.freqz(b, a, **kw)),
                      (tf.freqz(b, device="cpu", **kw), jf.freqz(b, **kw)),
                      (tf.sosfreqz(sos, device="cpu", **kw), jf.sosfreqz(sos, **kw)),
                      (tf.freqz_sos(T(sos), **kw), jf.freqz_sos(sos, **kw)),
                      (tf.freqz_zpk([0.5, -1.0], [0.3 + 0.2j, 0.3 - 0.2j], 2.0, device="cpu",
                                    **kw),
                       jf.freqz_zpk([0.5, -1.0], [0.3 + 0.2j, 0.3 - 0.2j], 2.0, **kw)),
                      (tf.group_delay(b, a, device="cpu", **kw), jf.group_delay(b, a, **kw)),
                      (tf.group_delay(T(b), **kw), jf.group_delay(b, **kw))]:
        assert got[1].dtype in (torch.float64, torch.complex128)
        close(got[0], want[0], 1e-10)
        close(got[1], want[1], 1e-10 * max(1.0, np.abs(np.asarray(want[1])).max()))
    with pytest.raises(ValueError, match="n_sections, 6"):
        tf.sosfreqz(np.ones((2, 5)))


@pytest.mark.parametrize("worN", [20, np.array([0.1, 1.0, 3.0, 30.0])])
def test_analog_responses_match_jax(worN):
    b, a = np.array([1.0, 0.5]), np.array([1.0, 2.0, 5.0])
    for got, want in [(tf.freqs(b, a, worN, device="cpu"), jf.freqs(b, a, worN)),
                      (tf.freqs_zpk([-0.5], [-1.0 + 2.0j, -1.0 - 2.0j], 3.0, worN,
                                    device="cpu"),
                       jf.freqs_zpk([-0.5], [-1.0 + 2.0j, -1.0 - 2.0j], 3.0, worN))]:
        close(got[0], want[0], 1e-10)
        close(got[1], want[1], 1e-10)
    np.testing.assert_array_equal(tl.findfreqs(b, a, 7), jl.findfreqs(b, a, 7))
    np.testing.assert_array_equal(tl.findfreqs([], [-2.0, -3.0], 5, kind="zp"),
                                  jl.findfreqs([], [-2.0, -3.0], 5, kind="zp"))


@pytest.mark.parametrize("w,p,d,pos,use", [(5, 2, 0, None, "conv"), (7, 3, 1, None, "dot"),
                                           (8, 3, 0, 2, "conv"), (11, 4, 2, 7, "dot"),
                                           (5, 2, 3, None, "conv")])
def test_savgol_coeffs_match_jax(w, p, d, pos, use):
    kw = dict(deriv=d, pos=pos, use=use, delta=0.5)
    close(tf.savgol_coeffs(w, p, dtype=torch.float64, device="cpu", **kw),
          jf.savgol_coeffs(w, p, dtype=jnp.float64, **kw), 1e-10)


@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest", "constant", "wrap"])
@pytest.mark.parametrize("w,p,d", [(5, 2, 0), (11, 3, 1), (7, 4, 2)])
def test_savgol_filter_matches_jax(mode, w, p, d, rng):
    x = rng.normal(size=(3, 60))
    kw = dict(deriv=d, mode=mode, cval=0.5, delta=0.25)
    close(tf.savgol_filter(T(x), w, p, **kw), jf.savgol_filter(jnp.asarray(x), w, p, **kw),
          1e-8, 1e-6)


def test_savgol_filter_axis_complex_and_errors(rng):
    x = rng.normal(size=(30, 4))
    close(tf.savgol_filter(T(x), 7, 2, axis=0),
          jf.savgol_filter(jnp.asarray(x), 7, 2, axis=0), 1e-8, 1e-6)
    z = rng.normal(size=40) + 1j * rng.normal(size=40)
    close(tf.savgol_filter(T(z), 5, 2, mode="mirror"),
          jf.savgol_filter(jnp.asarray(z), 5, 2, mode="mirror"), 1e-8, 1e-6)
    for args, kw in [((4, 2), {}), ((5, 5), {}), ((5, 2), dict(mode="bad")),
                     ((61, 2), {})]:
        with pytest.raises(ValueError) as want:
            jf.savgol_filter(jnp.asarray(x[:, 0]), *args, **kw)
        with pytest.raises(ValueError, match=str(want.value)[:25]):
            tf.savgol_filter(T(x[:, 0]), *args, **kw)


@pytest.mark.parametrize("kind", ["linear", "constant", "l", "c"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_detrend_matches_jax(kind, axis, rng):
    x = (rng.normal(size=(16, 50)) + np.linspace(0, 30, 50)).astype(np.float32)
    want = np.asarray(jf.detrend(jnp.asarray(x), axis=axis, type=kind))
    close(tf.detrend(T(x), axis=axis, type=kind), want, 1e-6 * np.abs(x).max())
    xd = x.astype(np.float64)
    close(tf.detrend(T(xd), axis=axis, type=kind),
          jf.detrend(jnp.asarray(xd), axis=axis, type=kind), 1e-10)
    with pytest.raises(ValueError, match="type must be"):
        tf.detrend(T(x), type="quadratic")


@pytest.mark.parametrize("shape,domain,rank", [((20,), np.ones(3), 1), ((20,), np.ones(5), 0),
                                               ((9, 8), np.ones((3, 3)), 4),
                                               ((9, 8), np.array([[0, 1, 0], [1, 1, 1],
                                                                  [0, 1, 0]]), 3),
                                               ((5, 6, 7), np.ones((3, 1, 3)), 8)])
def test_order_filter_matches_jax(shape, domain, rank, rng):
    a = rng.normal(size=shape).astype(np.float32)
    close(tf.order_filter(T(a), domain, rank), jf.order_filter(jnp.asarray(a), domain, rank),
          0.0)


def test_medfilt_matches_jax(rng):
    v = rng.normal(size=(11, 13)).astype(np.float32)
    for ks in (None, 3, (5, 3), (1, 7)):
        close(tf.medfilt(T(v), ks), jf.medfilt(jnp.asarray(v), ks), 0.0)
    close(tf.medfilt2d(T(v), 5), jf.medfilt2d(jnp.asarray(v), 5), 0.0)
    close(tf.medfilt(T(v[0]), 5), jf.medfilt(jnp.asarray(v[0]), 5), 0.0)
    for fn, args in [(tf.medfilt, (T(v), 4)), (tf.medfilt2d, (T(v[0]),)),
                     (tf.order_filter, (T(v), np.ones((3, 3)), 9)),
                     (tf.order_filter, (T(v), np.ones((2, 3)), 1))]:
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("args", [(440.0, "fir", None, None, 16000.0),
                                  (1000.0, "fir", 3, 100, 8000.0), (440.0, "iir", None, None,
                                                                    16000.0),
                                  (0.3, "iir")])
def test_gammatone_matches_jax(args):
    for got, want in zip(tf.gammatone(*args), jf.gammatone(*args)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="ftype"):
        tf.gammatone(440.0, "fft", fs=16000.0)


@pytest.mark.parametrize("nbits,kw", [(3, {}), (8, {}), (10, dict(length=300)),
                                      (5, dict(state=[0, 1, 0, 0, 1])),
                                      (6, dict(taps=[5, 2], length=40)), (4, dict(length=0))])
def test_max_len_seq_matches_jax(nbits, kw):
    seq, state = tf.max_len_seq(nbits, device="cpu", **kw)
    want_seq, want_state = jf.max_len_seq(nbits, **kw)
    assert seq.dtype == torch.int8
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(state, want_state)
    assert state.dtype == np.int8


def test_max_len_seq_errors_match_jax():
    for kw in [dict(nbits=40), dict(nbits=4, state=[0, 0, 0, 0]), dict(nbits=4, length=-1),
               dict(nbits=4, taps=[9]), dict(nbits=4, state=[1, 1])]:
        with pytest.raises(ValueError) as want:
            jf.max_len_seq(**kw)
        with pytest.raises(ValueError) as got:
            tf.max_len_seq(**kw)
        assert str(got.value) == str(want.value)
