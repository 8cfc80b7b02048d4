"""Parity of the PyTorch port's ops/convolution.py (and the utils it uses)
with the JAX package, on the CPU.

Tolerances:
* every convolution: 1e-5 x max|reference| — both sides are f32 sums in
  different orders (conv1d / torch.fft against XLA's conv / FFT).
* correlation_lags, choose_conv_method, the shape helpers: exact.
* oaconvolve's overlap-add: bitwise equal to the left fold of its own
  blocks (the JAX path is the same fold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import convolution as jc
from nx_signal_tpu.utils import dtypes as jdt
from nx_signal_tpu.utils import shapes as jsh
from nx_signal_tpu_torch.kernels.cuda_dft import _ola_fold_torch
from nx_signal_tpu_torch.ops import convolution as tc
from nx_signal_tpu_torch.ops import transforms as ttr
from nx_signal_tpu_torch.utils import dtypes as tdt
from nx_signal_tpu_torch.utils import shapes as tsh


def assert_close_to_max(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(initial=1e-30))


def make(rng, shape, kind):
    a = rng.normal(size=shape)
    if kind == "complex":
        return (a + 1j * rng.normal(size=shape)).astype(np.complex64)
    return a.astype(np.float32)


def both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


SHAPES = {  # signal shape, kernel shape
    "1d_odd": ((300,), (31,)),
    "1d_even": ((300,), (30,)),
    "batched_even": ((3, 257), (1, 64)),
    "2d": ((20, 24), (5, 4)),
    "short_signal": ((10,), (17,)),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("method", ["direct", "fft"])
def test_convolve(case, mode, kind, method, rng):
    s1, s2 = SHAPES[case]
    a, b = make(rng, s1, kind), make(rng, s2, "real" if method == "fft" else kind)
    got, want = both(tc.convolve, jc.convolve, a, b, mode=mode, method=method)
    assert got.dtype == (torch.complex64 if kind == "complex" else torch.float32)
    assert_close_to_max(got, want)


@pytest.mark.parametrize("k", [4, 5])
def test_convolve_same_alignment_even_and_odd(k, rng):
    """'same' keeps the centre with the extra sample of an even kernel on
    the left (scipy), which conv1d(padding='same') would put on the right;
    held against numpy, which follows scipy."""
    a, b = make(rng, (40,), "real"), make(rng, (k,), "real")
    want = np.convolve(a.astype(np.float64), b.astype(np.float64), mode="same")
    for method in ("direct", "fft"):
        got = tc.convolve(torch.from_numpy(a), torch.from_numpy(b), mode="same", method=method)
        assert_close_to_max(got, want)
    # the general N-D path (no Toeplitz contraction) agrees too
    got = tc._direct_convolve(torch.from_numpy(a), torch.from_numpy(b), "same", use_matmul=False)
    assert_close_to_max(got, want)


def test_convolve_rank4_and_scalar(rng):
    a, b = make(rng, (3, 4, 5, 6), "real"), make(rng, (2, 2, 3, 2), "real")
    for mode in ("full", "same", "valid"):
        got, want = both(tc.convolve, jc.convolve, a, b, mode=mode)
        assert_close_to_max(got, want)
    assert float(tc.convolve(torch.tensor(2.0), torch.tensor(3))) == 6.0


def test_convolve_errors():
    with pytest.raises(ValueError, match="mode"):
        tc.convolve(torch.ones(4), torch.ones(2), mode="middle")
    with pytest.raises(ValueError, match="method"):
        tc.convolve(torch.ones(4), torch.ones(2), method="winograd")
    with pytest.raises(ValueError, match="same rank"):
        tc.convolve(torch.ones(4), torch.ones(2, 2))
    with pytest.raises(ValueError, match="Incompatible ranks"):
        tc.convolve(torch.tensor(1.0), torch.ones(2))
    with pytest.raises(ValueError, match="at least as large"):
        tc.convolve(torch.ones(4, 2), torch.ones(2, 4), mode="valid")


def test_convolve_integer_promotes_to_float32():
    got = tc.convolve(torch.tensor([1, 2, 3]), torch.tensor([1, 1]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), [1, 3, 5, 3])


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_correlate(mode, kind, rng):
    a, b = make(rng, (50,), kind), make(rng, (8,), kind)
    got, want = both(tc.correlate, jc.correlate, a, b, mode=mode)
    assert_close_to_max(got, want)


FFT_SHAPES = [((40,), (7,)), ((4, 33), (1, 6)), ((5, 30), (3, 1)), ((12, 10), (4, 3)),
              ((1, 20), (3, 5))]


@pytest.mark.parametrize("shapes,mode", [
    (shapes, mode) for shapes in FFT_SHAPES for mode in ("full", "same", "valid")
    # 'valid' needs one operand at least as large as the other on every axis
    if mode != "valid" or all(a >= b for a, b in zip(*shapes))])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_fftconvolve(shapes, mode, kind, rng):
    s1, s2 = shapes
    a, b = make(rng, s1, kind), make(rng, s2, "real")
    got, want = both(tc.fftconvolve, jc.fftconvolve, a, b, mode=mode)
    assert_close_to_max(got, want)


@pytest.mark.parametrize("shapes", [((1000,), (31,)), ((1000,), (30,)), ((3, 700), (1, 64)),
                                    ((2, 500), (2, 9)), ((20,), (100,))])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_oaconvolve(shapes, mode, kind, rng):
    a, b = make(rng, shapes[0], kind), make(rng, shapes[1], "real")
    got, want = both(tc.oaconvolve, jc.oaconvolve, a, b, mode=mode)
    assert_close_to_max(got, want)


@pytest.mark.parametrize("block_length", [None, 64, 200])
def test_oaconvolve_block_length_and_left_fold(block_length, rng):
    a, b = make(rng, (2, 900), "real"), make(rng, (1, 40), "real")
    got, want = both(tc.oaconvolve, jc.oaconvolve, a, b, block_length=block_length)
    assert_close_to_max(got, want)
    # the overlap-add is the left fold of its own blocks, bitwise
    block = max(block_length or tc._oa_block_length(40), 40)
    step = block - 39
    nb = -(-900 // step)
    blocks = torch.nn.functional.pad(torch.from_numpy(a), (0, nb * step - 900)).reshape(
        2, nb, step)
    conv = torch.fft.irfft(torch.fft.rfft(blocks, n=block) * torch.fft.rfft(
        torch.from_numpy(b), n=block)[..., None, :], n=block)
    fold = _ola_fold_torch(conv[..., :step + 39], step, nb * step + 39)[..., :939]
    assert torch.equal(got, fold)


def test_oaconvolve_degenerate_cases(rng):
    for s1, s2 in [((1,), (5,)), ((10,), (1,)), ((3, 20), (2, 4))]:
        a, b = make(rng, s1, "real"), make(rng, s2, "real")
        got, want = both(tc.oaconvolve, jc.oaconvolve, a, b)
        assert_close_to_max(got, want)
    with pytest.raises(ValueError, match="Rank"):
        tc.oaconvolve(torch.ones(4), torch.ones(1, 2))


@pytest.mark.parametrize("k", [2, 31, 64])
@pytest.mark.parametrize("origin", [0, 37, 700])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fir_convolve_1d(k, origin, mode, rng):
    a, b = make(rng, (2, 1100), "real"), make(rng, (k,), "real")
    got, want = both(tc.fir_convolve_1d, jc.fir_convolve_1d, a, b, mode=mode, origin=origin)
    assert_close_to_max(got, want)


def test_fir_convolve_1d_complex_and_short(rng):
    a, b = make(rng, (300,), "complex"), make(rng, (12,), "real")
    got, want = both(tc.fir_convolve_1d, jc.fir_convolve_1d, a, b, mode="same")
    assert got.dtype == torch.complex64
    assert_close_to_max(got, want)
    a, b = make(rng, (5,), "real"), make(rng, (9,), "real")
    got, want = both(tc.fir_convolve_1d, jc.fir_convolve_1d, a, b, mode="valid")
    assert_close_to_max(got, want)


def test_direct_convolutions_run_without_tf32(monkeypatch, rng):
    """Every conv of the plain convolution paths runs with TF32 off (cuDNN's
    default is TF32, three digits)."""
    import torch.nn.functional as F

    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(F, "conv1d", spy(F.conv1d))
    for rank in (1, 2, 3):
        monkeypatch.setitem(tc._CONV, rank, spy(tc._CONV[rank]))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    a = make(rng, (4, 300), "real")
    tc.convolve(torch.from_numpy(a), torch.ones(1, 9), mode="same")          # Toeplitz
    tc.convolve(torch.from_numpy(a), torch.ones(3, 9), mode="same")          # conv2d
    tc.convolve2d(torch.from_numpy(a), torch.ones(2, 2), boundary="symm")
    assert len(seen) >= 3 and all(flags == (False, False) for flags in seen)
    assert torch.backends.cudnn.allow_tf32  # restored


@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("fn", ["convolve2d", "correlate2d"])
def test_convolve2d_correlate2d(boundary, mode, kind, fn, rng):
    a, b = make(rng, (9, 11), kind), make(rng, (4, 3), kind)
    got, want = both(getattr(tc, fn), getattr(jc, fn), a, b, mode=mode, boundary=boundary)
    assert_close_to_max(got, want)


@pytest.mark.parametrize("fn", ["convolve2d", "correlate2d"])
def test_convolve2d_fillvalue_and_valid_swap(fn, rng):
    a, b = make(rng, (6, 7), "complex"), make(rng, (3, 2), "complex")
    got, want = both(getattr(tc, fn), getattr(jc, fn), a, b, mode="same", fillvalue=1.5)
    assert_close_to_max(got, want)
    got, want = both(getattr(tc, fn), getattr(jc, fn), b, a, mode="valid")  # swapped
    assert_close_to_max(got, want)
    with pytest.raises(ValueError, match="boundary"):
        tc.convolve2d(torch.ones(3, 3), torch.ones(2, 2), boundary="reflect")
    with pytest.raises(ValueError, match="rank 2"):
        getattr(tc, fn)(torch.ones(3), torch.ones(2))


@pytest.mark.parametrize("n1,n2", [(3, 3), (5, 2), (2, 5), (6, 4), (7, 7), (1, 4)])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlation_lags(n1, n2, mode):
    np.testing.assert_array_equal(tc.correlation_lags(n1, n2, mode),
                                  np.asarray(jc.correlation_lags(n1, n2, mode)))


def test_correlation_lags_errors():
    with pytest.raises(ValueError, match="mode"):
        tc.correlation_lags(3, 3, "middle")
    with pytest.raises(ValueError, match=">= 1"):
        tc.correlation_lags(0, 3)


@pytest.mark.parametrize("shapes,dtypes", [
    (((100,), (5,)), ("f", "f")), (((5000,), (4096,)), ("f", "f")),
    (((5000,), (4096,)), ("i", "i")), (((70, 70), (65, 65)), ("f", "f")),
    (((5000,), (64, 64)), ("f", "f"))])
def test_choose_conv_method(shapes, dtypes):
    arrays = [np.zeros(s, dtype=np.float32 if d == "f" else np.int32)
              for s, d in zip(shapes, dtypes)]
    assert tc.choose_conv_method(*map(torch.from_numpy, arrays)) == \
        jc.choose_conv_method(*map(jnp.asarray, arrays))


@pytest.mark.parametrize("num,den", [([1.0, 3.0, 3.0, 1.0], [1.0, 1.0]),
                                     ([2.0, 1.0, 0.5, 4.0, 1.0], [2.0, -0.5, 0.25]),
                                     ([1.0, 2.0], [1.0, 2.0, 3.0])])
def test_deconvolve(num, den):
    num, den = np.asarray(num, np.float32), np.asarray(den, np.float32)
    (q, r), (jq, jr) = both(tc.deconvolve, jc.deconvolve, num, den)
    assert_close_to_max(q, jq)
    assert_close_to_max(r, np.asarray(jr), rel=1e-5 if np.abs(jr).max() > 1e-3 else 1e-4)
    if q.numel():
        recon = tc.convolve(torch.from_numpy(den), q) + r
        np.testing.assert_allclose(recon.numpy(), num, rtol=0, atol=1e-5 * np.abs(num).max())
    with pytest.raises(ValueError, match="1-D"):
        tc.deconvolve(torch.ones(2, 2), torch.ones(2))


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000, 4097, 100001])
def test_shape_helpers(n):
    assert tsh.fft_fast_length(n) == jsh.fft_fast_length(n)
    assert tsh.next_fast_len(n) == jsh.next_fast_len(n)
    for mode in ("full", "same", "valid"):
        assert tsh.conv_output_length(n, 3, mode) == jsh.conv_output_length(n, 3, mode)
    with pytest.raises(ValueError, match="mode"):
        tsh.conv_output_length(n, 3, "middle")


@pytest.mark.parametrize("dtypes,want", [
    ((torch.int32,), torch.float32), ((torch.float16,), torch.float32),
    ((torch.float64,), torch.float64), ((torch.float32, torch.complex128), torch.float64),
    ((torch.bool, torch.complex64), torch.float32)])
def test_dtype_helpers(dtypes, want):
    assert tdt.result_real_dtype(*dtypes) == want
    np_names = {torch.int32: np.int32, torch.float16: np.float16, torch.float64: np.float64,
                torch.float32: np.float32, torch.complex128: np.complex128,
                torch.bool: np.bool_, torch.complex64: np.complex64}
    assert str(jdt.result_real_dtype(*(np_names[d] for d in dtypes))) == str(want)[6:]
    assert tdt.default_complex(want) == (torch.complex128 if want == torch.float64
                                         else torch.complex64)
    assert tdt.complex_part_dtype(tdt.default_complex(want)) == want
    assert tdt.is_complex_dtype(torch.complex64) and not tdt.is_complex_dtype(want)


@pytest.mark.parametrize("fn", ["fft_nd", "ifft_nd", "rfft_nd"])
def test_transforms(fn, rng):
    a = make(rng, (6, 10), "real")
    got, want = both(getattr(ttr, fn), getattr(__import__(
        "nx_signal_tpu.ops.transforms", fromlist=[fn]), fn), a, axes=[0, 1], lengths=[8, 16])
    assert_close_to_max(got, want)
    with pytest.raises(ValueError, match="lengths must match axes"):
        getattr(ttr, fn)(torch.from_numpy(a), axes=[0], lengths=[2, 3])


def test_irfft_nd(rng):
    a = make(rng, (4, 9), "complex")
    from nx_signal_tpu.ops.transforms import irfft_nd

    got, want = both(ttr.irfft_nd, irfft_nd, a, axes=[1], lengths=[16])
    assert_close_to_max(got, want)
