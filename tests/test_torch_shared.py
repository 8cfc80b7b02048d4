"""The shared hop-block form of the FIR + framed DFT chain in the PyTorch
port (kernels/dft.py: recognize_cosine_window, shared_fold_weights,
fir_framed_dft_shared, kernel='cuda_shared'; kernel D's plain version) and
`edge='conv'`, held against the JAX package on the CPU.

Tolerances:
* host builders (recognize_cosine_window, shared_fold_weights, the
  twiddle table): exact / bitwise — the same numpy f64 arithmetic.
* fir_framed_dft_shared and kernel D's plain version against the JAX
  function and the Pallas kernel in interpret mode: 1e-5 x max, the JAX
  package's own gate for these geometries (tests/test_pallas_kernels.py);
  the sums run in other orders.
* the shared form against the dense fir_framed_dft: 1e-4 x max (the two
  forms round differently; not bitwise).
* edge='conv' against the JAX edge='conv': 1e-4 x max (f32 contractions in
  other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.kernels import dft as jd
from nx_signal_tpu.kernels.pallas_dft import fir_framed_dft_power_shared_pallas
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu_torch.kernels import cuda_dft
from nx_signal_tpu_torch.kernels import dft as td
from nx_signal_tpu_torch.ops import windows as tw


def assert_close_to_max(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# the geometries of the JAX package's shared-kernel tests
# (tests/test_pallas_kernels.py:TestSharedPallas)
GEOMETRIES = [  # batch, length, taps, stride, n_fft, window
    ((2,), 5000, 255, 128, 512, "hann"),      # bench geometry
    ((3, 2), 9000, 63, 128, 512, "blackman"),  # 3-D batch, 2 neighbour bins
    ((1,), 4000, 1, 256, 512, "hamming"),      # J = 2, 1-tap FIR
    ((2,), 20000, 129, 128, 1024, "hann"),     # J = 8
]


def geometry_inputs(geometry, rng):
    batch, length, k, stride, n_fft, wname = geometry
    x = rng.normal(size=(*batch, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = np.asarray(getattr(jw, wname)(n_fft))
    return x, taps, window, stride, n_fft


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("n", [64, 512])
def test_recognize_cosine_window(name, n):
    window = np.array(getattr(jw, name)(n))
    want = jd.recognize_cosine_window(window, n)
    assert want is not None
    assert td.recognize_cosine_window(window, n) == want
    assert td.recognize_cosine_window(torch.from_numpy(window), n) == want
    assert td.recognize_cosine_window(getattr(tw, name)(n, device="cpu"), n) == want


@pytest.mark.parametrize("window,n_fft", [
    (np.ones(128), 128),                              # rectangular
    (np.asarray(jw.kaiser(256, beta=8.0)), 256),      # not a cosine sum
    (np.asarray(jw.hann(256, periodic=False)), 256),  # symmetric, not periodic
    (np.asarray(jw.hann(256)), 512),                  # wrong period
    (np.ones((2, 8)), 8),                             # not 1-D
])
def test_recognize_cosine_window_others(window, n_fft):
    assert td.recognize_cosine_window(window, n_fft) == jd.recognize_cosine_window(window, n_fft)


@pytest.mark.parametrize("num_taps", [None, 1, 4, 63, 255])
@pytest.mark.parametrize("stride,n_fft", [(128, 512), (256, 512), (64, 1024)])
def test_shared_fold_weights_bitwise(num_taps, stride, n_fft, rng):
    e_mat = jd._dft_weights(np.ones(stride), stride, n_fft, True, np.float64)
    if num_taps is None:
        taps, want = None, e_mat
    else:
        taps = rng.normal(size=num_taps).astype(np.float32)
        want = jd.toeplitz_band(np.asarray(taps, np.float64), stride, np) @ e_mat
    got = td.shared_fold_weights(taps, stride, n_fft, device="cpu")
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


@pytest.mark.parametrize("stride,n_fft,onesided", [(128, 512, True), (256, 512, False),
                                                   (128, 1024, True), (100, 400, True)])
def test_shared_twiddles_bitwise(stride, n_fft, onesided):
    bins = n_fft // 2 + 1 if onesided else n_fft
    jk = (np.arange(n_fft // stride)[:, None] * np.arange(bins)[None, :] * stride) % n_fft
    ang = -2.0 * np.pi * jk / n_fft
    want = np.stack([np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)])
    got = td.shared_twiddles(stride, n_fft, onesided, device="cpu")
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("output", ["power", "complex"])
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("with_taps", [True, False])
def test_fir_framed_dft_shared_matches_jax(geometry, output, onesided, with_taps, rng):
    x, taps, window, stride, n_fft = geometry_inputs(geometry, rng)
    taps = taps if with_taps else None
    coeffs = jd.recognize_cosine_window(window, n_fft)
    want = np.asarray(jd.fir_framed_dft_shared(jnp.asarray(x), taps, stride=stride,
                                               n_fft=n_fft, window_coeffs=coeffs,
                                               onesided=onesided, output=output))
    before = cuda_dft.fir_framed_dft_power_shared_cuda.launches
    got = td.fir_framed_dft_shared(torch.from_numpy(x), taps, stride=stride, n_fft=n_fft,
                                   window_coeffs=coeffs, onesided=onesided, output=output)
    assert cuda_dft.fir_framed_dft_power_shared_cuda.launches == before  # CPU: plain
    assert got.dtype == (torch.float32 if output == "power" else torch.complex64)
    assert_close_to_max(got, want.astype(got.numpy().dtype), 1e-5)


@pytest.mark.parametrize("geometry", GEOMETRIES[:2])
def test_shared_plain_matches_pallas_interpret(geometry, rng):
    x, taps, window, stride, n_fft = geometry_inputs(geometry, rng)
    coeffs = jd.recognize_cosine_window(window, n_fft)
    want = fir_framed_dft_power_shared_pallas(jnp.asarray(x), taps, stride=stride,
                                              n_fft=n_fft, window_coeffs=coeffs,
                                              interpret=True)
    bins = n_fft // 2 + 1
    got = cuda_dft.fir_framed_dft_power_shared_cuda(
        torch.from_numpy(x), td.shared_fold_weights(taps, stride, n_fft, device="cpu"),
        td.shared_twiddles(stride, n_fft, device="cpu"), coeffs, stride=stride,
        pad_left=td._same_pad_left(taps.size), num_frames=(x.shape[-1] - n_fft) // stride + 1,
        bins=bins)
    assert_close_to_max(got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_shared_matches_dense_chain(geometry, rng):
    x, taps, window, stride, n_fft = geometry_inputs(geometry, rng)
    kw = dict(stride=stride, n_fft=n_fft, onesided=True, output="power")
    dense = td.fir_framed_dft(torch.from_numpy(x), taps, window, kernel="torch", **kw)
    shared = td.fir_framed_dft(torch.from_numpy(x), taps, window, kernel="cuda_shared", **kw)
    assert_close_to_max(shared, dense, 1e-4)
    coeffs = td.recognize_cosine_window(window, n_fft)
    assert torch.equal(shared, td.fir_framed_dft_shared(torch.from_numpy(x), taps,
                                                        window_coeffs=coeffs, **kw))


@pytest.mark.parametrize("change,match", [
    (dict(output="complex"), "requires output='power'"),
    (dict(onesided=False), "requires output='power'"),
    (dict(edge="conv"), "requires output='power'"),
    (dict(complex_input=True), "requires output='power'"),
    (dict(window="hann400"), "frame_length == n_fft"),
    (dict(stride=96), "stride | n_fft"),
    (dict(n_fft=510, window="hann510"), "even n_fft"),
    (dict(window="symmetric"), "recognized cosine-sum window"),
    (dict(window="kaiser"), "recognized cosine-sum window"),
])
def test_cuda_shared_eligibility_errors(change, match):
    kw = dict(stride=128, n_fft=512, onesided=True, output="power", edge="pad")
    windows = {"hann": np.asarray(jw.hann(512)), "hann400": np.asarray(jw.hann(400)),
               "hann510": np.asarray(jw.hann(510)),
               "symmetric": np.asarray(jw.hann(512, periodic=False)),
               "kaiser": np.asarray(jw.kaiser(512, beta=8.0))}
    change = dict(change)
    window = windows[change.pop("window", "hann")]
    x = torch.zeros(2, 4000, dtype=torch.complex64 if change.pop("complex_input", False)
                    else torch.float32)
    kw.update(change)
    with pytest.raises(ValueError, match=match):
        td.fir_framed_dft(x, np.ones(5), window, kernel="cuda_shared", **kw)


@pytest.mark.parametrize("stride,n_fft", [(100, 400), (30, 60)])
def test_cuda_shared_takes_any_hop(stride, n_fft, rng):
    """The TPU lane rule stride % 128 == 0 is dropped."""
    x = torch.from_numpy(rng.normal(size=(2, 3000)).astype(np.float32))
    taps, window = rng.normal(size=20), np.asarray(jw.hann(n_fft))
    kw = dict(stride=stride, n_fft=n_fft, onesided=True, output="power")
    assert_close_to_max(td.fir_framed_dft(x, taps, window, kernel="cuda_shared", **kw),
                        td.fir_framed_dft(x, taps, window, kernel="torch", **kw), 1e-4)


def test_fir_framed_dft_shared_errors():
    x, kw = torch.zeros(2, 4000), dict(window_coeffs=(0.5, -0.5), onesided=True)
    with pytest.raises(ValueError, match="stride | n_fft"):
        td.fir_framed_dft_shared(x, None, stride=100, n_fft=512, **kw)
    with pytest.raises(ValueError, match="even n_fft"):
        td.fir_framed_dft_shared(x, None, stride=3, n_fft=513, **kw)
    with pytest.raises(ValueError, match="1..stride terms"):
        td.fir_framed_dft_shared(x, None, stride=2, n_fft=512, window_coeffs=(1, 2, 3))
    with pytest.raises(ValueError, match="exceeds signal length"):
        td.fir_framed_dft_shared(torch.zeros(100), None, stride=128, n_fft=512, **kw)
    with pytest.raises(ValueError, match="output"):
        td.fir_framed_dft_shared(x, None, stride=128, n_fft=512, output="abs", **kw)
    with pytest.raises(ValueError, match="precision"):
        td.fir_framed_dft_shared(x, None, stride=128, n_fft=512, precision="fast", **kw)


EDGE_GEOMETRIES = [  # channels, length, taps, frame, hop, n_fft
    (2, 5120, 255, 512, 128, 512),   # hop | length: the copy-free conv applies
    (1, 4096, 100, 400, 128, 512),   # even taps
    (2, 5000, 255, 512, 128, 512),   # hop does not divide the length: padded path
    (1, 2048, 1, 256, 128, 256),     # one block of context: padded path
]


@pytest.mark.parametrize("geometry", EDGE_GEOMETRIES)
@pytest.mark.parametrize("kernel", ["torch", "auto"])
def test_edge_conv_matches_jax(geometry, kernel, rng):
    channels, length, k, frame, hop, n_fft = geometry
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = np.asarray(jw.hann(frame))
    kw = dict(stride=hop, n_fft=n_fft, onesided=True, output="power")
    want = np.asarray(jd.fir_framed_dft(jnp.asarray(x), taps, window, edge="conv",
                                        kernel="xla", **kw))
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, edge="conv", kernel=kernel,
                            **kw)
    assert_close_to_max(got, want.astype(np.float32), 1e-4)
    pad = td.fir_framed_dft(torch.from_numpy(x), taps, window, edge="pad", kernel=kernel,
                            **kw)
    if kernel == "auto":  # kernel A's route ignores the edge mode
        assert torch.equal(got, pad)
    else:
        assert_close_to_max(got, pad, 1e-5)


def test_edge_conv_nopad_applies_only_where_the_geometry_allows(rng):
    weights = td.fir_dft_fold_weights(rng.normal(size=255), np.asarray(jw.hann(512)), 512,
                                      True, device="cpu")
    kw = dict(stride=128, pad_left=127, num_frames=5, bins=257)
    assert td._fir_framed_dft_power_nopad(torch.zeros(2, 1024), weights, **kw) is not None
    assert td._fir_framed_dft_power_nopad(torch.zeros(2, 1000), weights, **kw) is None
    short = weights[:100]   # one block of context (c_blocks == 1)
    assert td._fir_framed_dft_power_nopad(torch.zeros(2, 1024), short, **kw) is None
