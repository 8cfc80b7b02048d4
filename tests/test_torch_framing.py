"""Parity of the PyTorch port's framing and overlap-add with the JAX package.

Tolerance: bitwise everywhere. Padding and framing are pure data movement,
and the overlap-add fold adds the same f32 values in the same order
(increasing frame order per output sample) in both packages and in the
Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.kernels.pallas_dft import overlap_add_pallas
from nx_signal_tpu.spectral import framing as jf
from nx_signal_tpu_torch.kernels import cuda_dft
from nx_signal_tpu_torch.spectral import framing as tf


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("window,stride", [(512, 128), (400, 150), (7, 3), (5, 5), (3, 8)])
def test_frame_block_widths(window, stride):
    assert tf._frame_block_widths(window, stride) == jf._frame_block_widths(window, stride)


PADDINGS = ["valid", "same", "reflect", (3, 5), [(2, 0)]]


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("shape", [(37,), (2, 3, 37)])
@pytest.mark.parametrize("window_length", [8, 9])
def test_pad_for_windowing_bitwise(padding, shape, window_length, rng):
    x = rng.normal(size=shape).astype(np.float32)
    want = jf.pad_for_windowing(jnp.asarray(x), window_length, padding)
    got = tf.pad_for_windowing(torch.from_numpy(x), window_length, padding)
    assert_bitwise(got, want)


def test_pad_for_windowing_reflect_wider_than_signal(rng):
    # numpy 'reflect' repeats the reflection when the pad exceeds the signal
    x = rng.normal(size=(2, 5)).astype(np.float32)
    want = jf.pad_for_windowing(jnp.asarray(x), 16, "reflect")
    assert_bitwise(tf.pad_for_windowing(torch.from_numpy(x), 16, "reflect"), want)


def test_pad_for_windowing_reflect_is_numpys_at_every_length():
    """The reflection index, built on the signal's device, is numpy's
    'reflect' for every signal length and pad, repeated reflections and
    one-sample signals included."""
    for n in range(1, 40):
        for window_length in range(0, 240, 3):
            half = window_length // 2
            want = np.pad(np.arange(n), (half, half), mode="reflect")
            got = tf.pad_for_windowing(torch.arange(n), window_length, "reflect")
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n} pad={half}")


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("stride", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_as_windowed_bitwise(padding, stride, dtype, rng):
    x = (rng.normal(size=(2, 37)) * 100).astype(dtype)
    want = jf.as_windowed(jnp.asarray(x), window_length=8, stride=stride, padding=padding)
    got = tf.as_windowed(torch.from_numpy(x), window_length=8, stride=stride, padding=padding)
    assert_bitwise(got, want)


def test_as_windowed_errors():
    with pytest.raises(ValueError, match="stride"):
        tf.as_windowed(torch.zeros(10), window_length=4, stride=0)
    with pytest.raises(ValueError, match="exceeds"):
        tf.as_windowed(torch.zeros(3), window_length=4)
    with pytest.raises(ValueError, match="padding"):
        tf.as_windowed(torch.zeros(10), window_length=4, padding="circular")


OLA_GEOMETRIES = [  # frames, frame length, hop, extra output samples
    (12, 512, 128, 0),
    (9, 400, 150, 0),     # ragged last block
    (7, 7, 3, 0),
    (5, 8, 8, 0),         # no overlap
    (4, 5, 8, 0),         # gaps between frames
    (6, 16, 4, -5),       # output cut short
    (3, 10, 4, 9),        # output longer than the frames reach
]


@pytest.mark.parametrize("m,n,stride,extra", OLA_GEOMETRIES)
@pytest.mark.parametrize("batch", [(), (2, 3)])
def test_ola_fold_bitwise(m, n, stride, extra, batch, rng):
    frames = rng.normal(size=(*batch, m, n)).astype(np.float32)
    out_length = m * stride + max(n - stride, 0) + extra
    want = jf._ola_fold(jnp.asarray(frames), stride, out_length)
    assert_bitwise(tf._ola_fold_torch(torch.from_numpy(frames), stride, out_length), want)
    # the kernel wrapper on a CPU tensor is the plain fold, and launches nothing
    before = cuda_dft.overlap_add_cuda.launches
    got = cuda_dft.overlap_add_cuda(torch.from_numpy(frames), stride=stride,
                                    out_length=out_length)
    assert cuda_dft.overlap_add_cuda.launches == before
    assert_bitwise(got, want)


@pytest.mark.parametrize("m,n,stride,extra", OLA_GEOMETRIES)
@pytest.mark.parametrize("seed_length", ["short", "exact", "long"])
def test_ola_fold_with_init_bitwise(m, n, stride, extra, seed_length, rng):
    """The seeded fold, (((init + f_m0) + f_m1) + ...), against the JAX fold
    with the same init: cut to the grid, zero-padded, and -0.0 seeds meet
    the same +0.0 terms as the JAX fold's zero-padded blocks."""
    frames = rng.normal(size=(2, m, n)).astype(np.float32)
    frames[0, 0, :3] = -0.0
    out_length = m * stride + max(n - stride, 0) + extra
    length = {"short": max(out_length // 3, 1), "exact": out_length,
              "long": out_length + 2 * stride + 1}[seed_length]
    init = rng.normal(size=(2, length)).astype(np.float32)
    init[:, ::4] = -0.0
    want = jf._ola_fold(jnp.asarray(frames), stride, out_length, init=jnp.asarray(init))
    got = tf._ola_fold(torch.from_numpy(frames), stride, out_length,
                       init=torch.from_numpy(init))
    assert_bitwise(got, want)
    before = cuda_dft.overlap_add_cuda.launches
    assert_bitwise(cuda_dft.overlap_add_cuda(torch.from_numpy(frames), stride=stride,
                                             out_length=out_length,
                                             init=torch.from_numpy(init)), want)
    assert cuda_dft.overlap_add_cuda.launches == before
    # complex frames take the plain fold with the same seed
    cframes = frames + 1j * frames[::-1]
    cinit = init + 1j * init[::-1]
    want = jf._ola_fold(jnp.asarray(cframes), stride, out_length, init=jnp.asarray(cinit))
    assert_bitwise(tf._ola_fold(torch.from_numpy(cframes), stride, out_length,
                                init=torch.from_numpy(cinit)), want)


@pytest.mark.parametrize("seed", ["none", "complex", "real"])
@pytest.mark.parametrize("m,n,stride,extra", [(6, 16, 16, 0), (9, 12, 5, 3)])
def test_ola_fold_complex64_goes_through_kernel_c_per_part(seed, m, n, stride, extra, rng,
                                                           monkeypatch):
    """complex64 frames reach kernel C's wrapper twice, real part then
    imaginary part (each seeded by its part of the seed; a real seed seeds
    the real part only), and the result is bitwise the plain per-part fold,
    signed zeros included: with no overlap a -0.0 seed under -0.0 frames
    stays -0.0 in the real part beside a negative imaginary part, which a
    complex add would turn into +0.0."""
    calls = []
    wrapper = cuda_dft.overlap_add_cuda

    def counting(frames, **kw):
        calls.append((frames.dtype, kw["init"] is not None))
        return wrapper(frames, **kw)

    monkeypatch.setattr(cuda_dft, "overlap_add_cuda", counting)
    frames = (rng.normal(size=(2, m, n)) + 1j * rng.normal(size=(2, m, n))).astype(np.complex64)
    frames.real[:, :, :4] = -0.0
    frames.imag[:, :, :4] = -1.5
    out_length = m * stride + max(n - stride, 0) + extra
    init = {"none": None,
            "complex": (rng.normal(size=(2, out_length))
                        + 1j * rng.normal(size=(2, out_length))).astype(np.complex64),
            "real": rng.normal(size=(2, out_length)).astype(np.float32)}[seed]
    if init is not None:
        init.real[:, :4] = -0.0
    t_init = None if init is None else torch.from_numpy(init)
    got = tf._ola_fold(torch.from_numpy(frames), stride, out_length, init=t_init)
    assert calls == [(torch.float32, seed != "none"),
                     (torch.float32, seed == "complex")]
    want = tf._ola_fold_torch(torch.from_numpy(frames), stride, out_length, init=t_init)
    assert_bitwise(got, want)
    j_init = None if init is None else jnp.asarray(init)
    assert_bitwise(got, jf._ola_fold(jnp.asarray(frames), stride, out_length, init=j_init))
    if seed != "none" and stride == n:
        assert np.signbit(got.real.numpy()[:, :4]).all()


def test_ola_fold_init_batch_must_match():
    with pytest.raises(ValueError, match="batch shape"):
        tf._ola_fold(torch.zeros(2, 3, 8), 4, 16, init=torch.zeros(3, 16))


@pytest.mark.parametrize("shape,overlap", [((2, 6, 512), 384), ((5, 256), 128)])
def test_overlap_and_add_matches_pallas_interpret(shape, overlap, rng):
    frames = rng.normal(size=shape).astype(np.float32)
    want = overlap_add_pallas(jnp.asarray(frames), overlap_length=overlap, interpret=True)
    assert_bitwise(tf.overlap_and_add(torch.from_numpy(frames), overlap_length=overlap),
                   want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_overlap_and_add_bitwise(dtype, rng):
    frames = (rng.normal(size=(3, 9, 12)) * 50).astype(dtype)
    want = jf.overlap_and_add(jnp.asarray(frames), overlap_length=5)
    assert_bitwise(tf.overlap_and_add(torch.from_numpy(frames), overlap_length=5), want)


def test_overlap_and_add_cast_and_errors():
    frames = torch.tensor([[1, 1, 1, 1], [10, 10, 10, 10], [100, 100, 100, 100]])
    out = tf.overlap_and_add(frames, overlap_length=2, dtype=torch.float32)
    assert out.dtype == torch.float32
    assert out.tolist() == [1, 1, 11, 11, 110, 110, 100, 100]
    with pytest.raises(ValueError, match="less than the window size"):
        tf.overlap_and_add(frames, overlap_length=4)
    with pytest.raises(ValueError, match="rank"):
        tf.overlap_and_add(torch.zeros(4), overlap_length=1)


def test_overlap_add_cuda_contract():
    with pytest.raises(ValueError, match="float32"):
        cuda_dft.overlap_add_cuda(torch.zeros(2, 4, dtype=torch.float64), stride=2,
                                  out_length=6)
    with pytest.raises(ValueError, match="rank"):
        cuda_dft.overlap_add_cuda(torch.zeros(4), stride=2, out_length=6)
